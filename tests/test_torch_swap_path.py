"""repro_torch's baseline data plane (``cpu_bf16``, ``copy_out``,
``copy_in``, ``write_tokens``) against the JAX package's on the CPU, and
the staged swap plane's ordering against the engine's device work.

Copies are exact: the host pool and the device pool must equal the
reference's byte for byte, for repeated, unsorted and partial-last-block
block lists (the lists of tests/test_swap_path.py), and the baseline must
equal the staged path.

On CUDA a swap-in's scatter runs on the pool's own stream and does not
wait for the decode step in flight, except through the release events of
its target blocks (``PagedPools.note_released``); a swap-out's gather
waits for the event the engine records at dispatch.  ``DeviceShadow``
replays the order a device would see for a real-mode engine run on the
CPU and shows that this is enough: no compute operation still in flight
when a swap-in scatters touches a target block unless it was issued
before that block was freed; the trash block, which freed rows write, is
never a target; a block still being gathered by a swap-out is reused only
once that swap-out's future is done; and the prefix cache's pool reads
(the carry seeds) are covered alike.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache.paged import PagedPools as JaxPagedPools
from repro.cache.paged import PoolSpec as JaxPoolSpec
from repro_torch.cache.paged import PagedPools, PoolSpec
from repro_torch.configs import get_smoke_config
from repro_torch.core import (EngineConfig, FastSwitchEngine,
                              SamplingParams, ServingEngine)
from repro_torch.data.priority import PriorityTrace
from repro_torch.kernels import ops
from repro_torch.kernels.block_copy import runs_to_indices
from repro_torch.models import transformer as T

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402
from test_torch_prefix_cache import shared_prompts  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BS = 8
SPEC = dict(n_layers=2, n_kv_heads=2, head_dim=8, block_size=BS,
            num_gpu_blocks=16, num_cpu_blocks=24)


def _pair(seed=7):
    """The two packages' pools holding the same random (finite) device
    bytes."""
    rng = np.random.default_rng(seed)
    j = JaxPagedPools(JaxPoolSpec(**SPEC))
    t = PagedPools(PoolSpec(**SPEC), device="cpu")
    bits = (rng.integers(0, 2 ** 16, tuple(j.gpu.shape), dtype=np.uint16)
            & 0xBFFF)
    j.gpu = jnp.asarray(bits.view(jnp.bfloat16))
    t.gpu = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return j, t


def _gpu_bits(pools):
    if isinstance(pools, PagedPools):
        return pools.gpu.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(pools.gpu).view(np.uint16)


def test_cpu_bf16_is_a_zero_copy_view_of_the_host_pool():
    j, t = _pair()
    for p in (j, t):
        p.copy_out([3, 9, 1], [0, 7, 23])
    view = t.cpu_bf16()
    assert view.dtype == torch.bfloat16 and view.shape == t.cpu.shape
    np.testing.assert_array_equal(view.float().numpy(),
                                  np.asarray(j.cpu_bf16(), np.float32))
    t.cpu[0, 1, 5, 2, 1, 3] = 0x3F80                  # 1.0 in bf16
    assert float(view[0, 1, 5, 2, 1, 3]) == 1.0       # the same memory


# (gpu blocks, cpu blocks): the reference's runs flattened, unsorted
# blocks, a repeated source, repeated destinations (the last pair wins),
# and one block
CASES = {
    "runs": ([0, 1, 5, 6, 7, 8], [0, 1, 2, 3, 4, 5]),
    "unsorted": ([9, 3, 4, 12, 1], [17, 2, 21, 0, 8]),
    "repeated_source": ([2, 2, 7, 6], [3, 4, 5, 6]),
    "repeated_destination": ([5, 5, 11, 10], [9, 10, 11, 12]),
    "one": ([15], [23]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_out_and_copy_in_match_reference(case):
    """copy_out, then copy_in into a zeroed device pool: host and device
    pools byte-equal with the reference's after each."""
    gpu_ids, cpu_ids = CASES[case]
    j, t = _pair(seed=len(case))
    for p in (j, t):
        p.copy_out(gpu_ids, cpu_ids)
    np.testing.assert_array_equal(t.cpu, j.cpu)
    j.gpu = jnp.zeros_like(j.gpu)
    t.gpu = torch.zeros_like(t.gpu)
    back_gpu = list(reversed(gpu_ids))                # other pairing too
    for p in (j, t):
        p.copy_in(cpu_ids, back_gpu)
    np.testing.assert_array_equal(_gpu_bits(t), _gpu_bits(j))
    assert (t.h2d_transfers, t.staged_in_calls) == \
        (j.h2d_transfers, j.staged_in_calls)


def test_baseline_equals_the_staged_path():
    """The same blocks through the staged path and the host-mediated one
    give the same host and device pools (tests/test_swap_path.py)."""
    _, p1 = _pair()
    _, p2 = _pair()
    runs = [(0, 2), (5, 4)]
    blocks = runs_to_indices(runs)
    cpu_ids = list(range(len(blocks)))
    p1.copy_out_staged(runs, cpu_ids)
    p2.copy_out(blocks, cpu_ids)
    np.testing.assert_array_equal(p1.cpu, p2.cpu)
    p1.gpu = torch.zeros_like(p1.gpu)
    p2.gpu = torch.zeros_like(p2.gpu)
    p1.copy_in_staged(cpu_ids, runs)
    p2.copy_in(cpu_ids, blocks)
    assert torch.equal(p1.gpu.view(torch.int16), p2.gpu.view(torch.int16))


def test_partial_last_block_round_trips_through_the_baseline():
    """A context ending mid-block: write_tokens, copy_out, clobber,
    copy_in; the valid prefix reads back bit for bit, and both pools
    equal the reference's."""
    j, t = _pair(seed=11)
    n_tokens = 2 * BS + 3
    rng = np.random.RandomState(0)
    k = rng.randn(2, n_tokens, 2, 8).astype(np.float32)
    v = rng.randn(2, n_tokens, 2, 8).astype(np.float32)
    block_ids = [4, 9, 2]
    for p in (j, t):
        p.write_tokens(block_ids, 0, k, v)
    k0, v0 = t.read_tokens(block_ids, n_tokens)
    for p in (j, t):
        p.copy_out(block_ids, [0, 1, 2])
    j.gpu = jnp.zeros_like(j.gpu)
    t.gpu = torch.zeros_like(t.gpu)
    for p in (j, t):
        p.copy_in([0, 1, 2], block_ids)
    k1, v1 = t.read_tokens(block_ids, n_tokens)
    assert torch.equal(k0, k1) and torch.equal(v0, v1)
    np.testing.assert_array_equal(t.cpu, j.cpu)
    np.testing.assert_array_equal(_gpu_bits(t), _gpu_bits(j))


@pytest.mark.parametrize("offset,n_tokens,kind", [
    (0, 2 * BS + 3, "float32"),      # fused, partial last block
    (2 * BS, BS, "bfloat16"),        # fused, block-aligned, whole block
    (BS, 5, "tensor"),               # fused from a tensor (prefill_kv's)
    (2, 3, "float32"),               # per-block, inside one block
    (BS + 5, 3, "bfloat16"),         # per-block, to the block's end
])
def test_write_tokens_matches_reference(offset, n_tokens, kind):
    j, t = _pair(seed=offset + n_tokens)
    rng = np.random.RandomState(offset)
    k = rng.randn(2, n_tokens, 2, 8).astype(np.float32)
    v = rng.randn(2, n_tokens, 2, 8).astype(np.float32)
    block_ids = [6, 1, 13, 4]
    j.write_tokens(block_ids, offset, k, v)
    if kind == "bfloat16":                # the reference's bf16 arrays
        tk = np.asarray(jnp.asarray(k, jnp.bfloat16))
        tv = np.asarray(jnp.asarray(v, jnp.bfloat16))
    elif kind == "tensor":
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    else:
        tk, tv = k, v
    t.write_tokens(block_ids, offset, tk, tv)
    np.testing.assert_array_equal(_gpu_bits(t), _gpu_bits(j))


@pytest.mark.parametrize("offset,n_tokens", [(2, BS), (BS + 3, 2 * BS)])
def test_write_tokens_refuses_a_piece_past_its_block_as_the_reference(
        offset, n_tokens):
    """An unaligned offset whose first piece runs past its block raises in
    both packages, and leaves the port's pool unchanged."""
    j, t = _pair()
    k = np.ones((2, n_tokens, 2, 8), np.float32)
    before = _gpu_bits(t).copy()
    with pytest.raises(ValueError):
        j.write_tokens([0, 1, 2, 3], offset, k, k)
    with pytest.raises(ValueError):
        t.write_tokens([0, 1, 2, 3], offset, k, k)
    np.testing.assert_array_equal(_gpu_bits(t), before)


def test_staged_calls_take_the_event_argument_and_keep_the_cpu_path():
    """Off CUDA there is no stream: ``compute_event`` is None, the staged
    calls accept ``after=None`` and ``note_released`` keeps no record."""
    _, t = _pair()
    assert t.compute_event() is None
    t.note_released(0, 4)
    assert t._released == {} and t._out_stream is None
    t.copy_out_staged([(1, 2)], [3, 4], after=t.compute_event())
    t.copy_in_staged([3, 4], [(10, 2)])
    assert torch.equal(t.gpu[:, :, 10:12], t.gpu[:, :, 1:3])
    assert t.fenced_swap_ins == 0


# ---------------------------------------------------------------------------
# the order a device would see
# ---------------------------------------------------------------------------


class DeviceShadow:
    """The order a CUDA device would see for one real-mode engine's pool,
    kept beside a CPU run: the compute stream's operations (decode steps,
    prefill inserts, carry seeds) with the pool blocks each touches and
    writes, the completion points the host waits for (the runner's flush
    waits for the last step and everything queued before it), the release
    marks ``note_released`` records, and the staged swaps.

    At every swap-in it checks that each compute operation still in flight
    that touches a target block was issued before that block's release
    (whose event the scatter waits on); at every compute operation, that
    no swap-out whose future is not done gathers a block the operation
    writes; and that the trash block is never released nor a target."""

    def __init__(self, eng, monkeypatch):
        self.ops = []            # (touched blocks, written blocks, kind)
        self.done = 0            # ops[:done] are complete
        self.last_step = -1
        self.released = {}       # block -> len(ops) at its last release
        self.outs = []           # swap-out tasks moving data
        self.violations = []
        self.swap_ins = 0
        self.fenced = 0          # swap-ins a release event orders
        self.reused_out_sources = 0
        self.freed_row_steps = 0
        self.trash = eng.config.num_gpu_blocks - 1
        self.bs = eng.config.block_size
        runner, pools, swap = eng.runner, eng.pools, eng.swap
        real_flush, real_decode = runner.flush, runner.decode
        real_insert = runner.prefill_chunk_insert
        real_seed = ops.seed_prefill_carry
        real_release = eng.gpu_mgr.on_release
        real_in = pools.copy_in_staged
        real_dispatch = swap.dispatch

        def flush():
            if runner._pending is not None:
                self.done = max(self.done, self.last_step + 1)
            return real_flush()

        def decode(views, pool):
            out = real_decode(views, pool)
            touched, written = {self.trash}, set()
            for row, ids in enumerate(runner._row_blocks):
                touched |= set(ids)
                if row in runner._active_rows:
                    ctx = runner._row_ctx[row] - 1     # before the step
                    written.add(ids[ctx // self.bs] if ctx // self.bs
                                < len(ids) else self.trash)
            if len(runner._active_rows) < runner.batch_bucket:
                written.add(self.trash)                # freed rows
                self.freed_row_steps += 1
            self._op(touched, written, "step")
            self.last_step = len(self.ops) - 1
            return out

        def insert(rid, pool, staged):
            if staged is not None:
                blocks = {int(b) for b in staged[2]}
                self._op(blocks, blocks, "insert")
            return real_insert(rid, pool, staged)

        def seed(pool, block_ids, n_tokens, **kw):
            read = set(list(block_ids)[:-(-n_tokens // self.bs)])
            self._op(read, set(), "seed")
            return real_seed(pool, block_ids, n_tokens, **kw)

        def release(start, length):
            for b in range(start, start + length):
                if b == self.trash:
                    self.violations.append("the trash block was freed")
                self.released[b] = len(self.ops)
            real_release(start, length)

        def copy_in_staged(cpu_blocks, gpu_runs, *a, **k):
            targets = set(runs_to_indices(gpu_runs))
            self.swap_ins += 1
            if self.trash in targets:
                self.violations.append("a swap-in targets the trash block")
            fenced = False
            for i in range(self.done, len(self.ops)):
                touched, _, kind = self.ops[i]
                for b in touched & targets:
                    if i >= self.released.get(b, -1):
                        self.violations.append(
                            f"swap-in into block {b} beside a {kind} issued "
                            "after the block's release")
                    else:
                        fenced = True
            self.fenced += fenced
            for task in self.outs:
                if task.gpu_blocks & targets:
                    self.reused_out_sources += 1
                    if task.future is not None and not task.future.done():
                        self.violations.append(
                            "a swap-in reuses a block a swap-out still "
                            "gathers")
            return real_in(cpu_blocks, gpu_runs, *a, **k)

        def dispatch(clock, req_id, direction, *a, **k):
            task = real_dispatch(clock, req_id, direction, *a, **k)
            if direction == "out" and task.copy_fn is not None:
                self.outs.append(task)
            return task

        runner.flush, runner.decode = flush, decode
        runner.prefill_chunk_insert = insert
        monkeypatch.setattr(ops, "seed_prefill_carry", seed)
        eng.gpu_mgr.on_release = release
        pools.copy_in_staged = copy_in_staged
        swap.dispatch = dispatch

    def _op(self, touched, written, kind):
        self.outs = [t for t in self.outs
                     if t.future is not None and not t.future.done()]
        for task in self.outs:
            if task.gpu_blocks & written:
                self.violations.append(f"a {kind} writes a block a "
                                       "swap-out still gathers")
        self.ops.append((set(touched), set(written), kind))


@pytest.fixture(scope="module")
def smoke_bundle():
    cfg = get_smoke_config("qwen2-1.5b")
    return {"cfg": cfg, "params": T.init_params(cfg, seed=0, device="cpu")}


def test_swap_ins_never_race_the_step_in_flight(smoke_bundle, monkeypatch):
    """chip_smoke's engine workload at smoke size, swaps held to the
    clock: every swap-in's targets are clear of the compute work in
    flight, or ordered behind it by a release event; swap-outs' sources
    are reused only after their futures; freed rows write the trash
    block, which is never a target.  The release events are needed: some
    swap-in lands on blocks a step in flight still reads."""
    convs = chip_smoke.conversations(8, (256, 288, 320, 352),
                                     (96, 128, 160), max_tokens=32)
    cfg = EngineConfig(mode="real", num_gpu_blocks=160, num_cpu_blocks=1024,
                       max_running=8, max_batch=8, block_size=16,
                       seed=0).with_policy("fastswitch")
    eng = FastSwitchEngine(cfg, convs,
                           trace=PriorityTrace("random", 0.5, seed=13),
                           model_bundle=smoke_bundle)
    shadow = DeviceShadow(eng, monkeypatch)
    with chip_smoke.swaps_follow_the_clock():
        eng.run(max_iterations=100_000)
    eng.shutdown()
    assert eng.done()
    assert shadow.violations == []
    assert shadow.swap_ins > 0
    assert shadow.fenced > 0, "no swap-in needed a release event"
    assert shadow.reused_out_sources > 0
    assert shadow.freed_row_steps > 0
    print(f"swap-ins {shadow.swap_ins}, ordered by a release event "
          f"{shadow.fenced}, onto a swap-out's sources "
          f"{shadow.reused_out_sources}")


def test_prefix_cache_reads_never_race_a_swap_in(smoke_bundle, monkeypatch):
    """Six sharers of a system prompt (tests/test_torch_prefix_cache.py's
    prompts) under a priority storm in 24 blocks: their carry seeds read
    pool blocks on the compute stream, and no swap-in scatters into a
    block a seed or step in flight touches unless a release event orders
    it."""
    prompts = shared_prompts(smoke_bundle["cfg"].vocab_size, n_req=6)
    cfg = EngineConfig(mode="real", num_gpu_blocks=24, num_cpu_blocks=256,
                       max_running=6, max_batch=6,
                       prefix_cache=True).with_policy("fastswitch")
    eng = ServingEngine(cfg, trace=PriorityTrace("random", 0.5, seed=13),
                        model_bundle=smoke_bundle)
    shadow = DeviceShadow(eng, monkeypatch)
    with chip_smoke.swaps_follow_the_clock():
        eng.add_request(list(prompts[0]), SamplingParams(max_tokens=24),
                        handle=0)
        for _ in range(2):
            eng.step()
        for h, toks in enumerate(prompts[1:], start=1):
            eng.add_request(list(toks), SamplingParams(max_tokens=24),
                            handle=h)
        n = 0
        while eng.has_work() and n < 5000:
            eng.step()
            n += 1
    eng.shutdown()
    assert not eng.has_work()
    assert shadow.violations == []
    assert eng.prefix.stats()["hits"] > 0
    assert any(kind == "seed" for _, _, kind in shadow.ops)
    assert shadow.swap_ins > 0
