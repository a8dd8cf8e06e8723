"""A swap-in over a short CPU copy in the port (``ServingEngine._swap_in``,
``_resume_short_copy``): a copy valid for fewer positions than hold the
request's KV — contaminated by another request's swap-out, or cut short
for want of CPU blocks — is restored only up to its valid prefix, and the
rest is recomputed from the token history.

  * one real-mode case per branch, on the reduced qwen2-1.5b with the
    reference's weights: a copy that holds every position, a short copy,
    a copy with nothing valid, a short copy under a pinned shared prefix
    (the prefix cache pins the prompt's full blocks); each with and
    without chunked prefill.  The copy's
    bytes past its valid prefix are overwritten, as a contamination
    overwrites them.  The swap-in restores exactly the blocks of
    ``[shared, valid)``, the recomputation tiles ``[valid, context - 1)``
    from the block holding ``valid``, no first token is emitted, and
    every generated token is the dense forward's argmax or a near-tie;
  * a copy contaminated while its swap-in is in flight: the restored
    bytes are the copy's at dispatch (swap-in copies run inline);
  * a property over host pools and priority storms, sim mode: no swap-in
    restores a block past its copy's valid prefix, every short copy
    becomes a resume, and the sanitizer (R3 included) holds after every
    step.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:               # stub the decorators: defs still parse,
    class _NoStrategies:          # the property test skips
        def __getattr__(self, name):
            return lambda *a, **k: None
    st = _NoStrategies()

    def given(*a, **k):
        return lambda fn: pytest.mark.skip(
            reason="hypothesis not installed; see requirements-dev.txt")(fn)

    def settings(*a, **k):
        return lambda fn: fn

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from repro_torch.core import (POLICIES, EngineConfig, FastSwitchEngine,  # noqa: E402
                              ReqState, SamplingParams, ServingEngine,
                              check_engine_invariants)
from repro_torch.kernels.block_copy import runs_to_indices  # noqa: E402
from repro_torch.data.priority import PriorityTrace  # noqa: E402
from repro_torch.data.sharegpt import Conversation, Turn  # noqa: E402
from torch_parity import smoke_bundles  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BS = 16
PROMPT = 100            # the resumed request's prompt
DECODED = 40            # tokens it decodes before it is swapped out
MAX_TOKENS = 48
# with the prefix cache on, the prompt's full blocks but the one holding
# its last token are donated at its prefill and stay pinned: 6 blocks
SHARED = 96


@pytest.fixture(scope="module")
def bundle():
    return smoke_bundles()[1]


def _engine(bundle, chunk: int, prefix_cache: bool) -> ServingEngine:
    policy = dataclasses.replace(POLICIES["fastswitch"],
                                 chunked_prefill_tokens=chunk)
    cfg = EngineConfig(mode="real", num_gpu_blocks=64, num_cpu_blocks=64,
                       max_running=4, max_batch=4, block_size=BS,
                       prefix_cache=prefix_cache, check_invariants_every=1,
                       policy=policy)
    return ServingEngine(cfg, trace=PriorityTrace(), model_bundle=bundle,
                         stream_tokens=True)


def _drain(eng, got: dict, until=lambda: False) -> None:
    """Step ``eng`` until ``until()`` holds or its work is done, adding
    each request's streamed tokens to ``got``."""
    while eng.has_work() and not until():
        for out in eng.step():
            got.setdefault(out.handle, []).extend(out.token_ids)


def _swapped_request(eng, prompt) -> tuple:
    """Serve ``prompt`` until it has decoded ``DECODED`` tokens, then
    preempt it to SWAPPED and wait for its swap-out copies.  Returns
    (handle, streamed tokens by handle)."""
    got = {}
    rid = eng.add_request(list(prompt), SamplingParams(max_tokens=MAX_TOKENS))
    _drain(eng, got, lambda: eng._req(rid).generated >= DECODED)
    eng.runner.flush()
    eng._preempt(rid)
    assert eng._req(rid).state is ReqState.SWAPPED
    for t in list(eng.swap.ongoing_swap_out):
        if t.future is not None:
            t.future.result()
    return rid, got


def _overwrite_copy_past(eng, rid: int, valid: int, seed: int) -> None:
    """Mark ``rid``'s copy valid for its first ``valid`` positions and
    overwrite its host bytes past them with other (finite) KV, as a
    contaminating swap-out writes into the blocks it takes."""
    copy = eng.reuse.copies[rid]
    copy.valid_tokens = copy.stored_tokens = valid
    ids = eng.reuse.mgr.request_block_ids(rid)
    cpu = eng.pools.cpu
    g = torch.Generator().manual_seed(seed)
    for b in range(valid // BS, len(ids)):
        off = valid % BS if b == valid // BS else 0
        shape = cpu[:, :, ids[b], off:].shape
        junk = torch.randn(shape, generator=g).to(torch.bfloat16)
        cpu[:, :, ids[b], off:] = junk.view(torch.int16).numpy().view(
            np.uint16)


def _record(eng, rid: int) -> dict:
    """Record ``rid``'s swap-in dispatches (their GPU blocks), its prefill
    chunks ((first position, tokens)) and its first-token emissions."""
    seen = {"restored": [], "chunks": [], "first_tokens": 0}
    dispatch, compute = eng._dispatch_swap, eng.runner.prefill_chunk_compute
    emit = eng._emit_first_token

    def on_dispatch(r, direction, runs, *a, **k):
        if r == rid and direction == "in":
            seen["restored"].extend(runs_to_indices(runs))
        return dispatch(r, direction, runs, *a, **k)

    def on_compute(r, n):
        if r == rid:
            seen["chunks"].append((eng.runner._prefills[r].pos, n))
        return compute(r, n)

    def on_emit(r):
        seen["first_tokens"] += r == rid
        return emit(r)
    eng._dispatch_swap = on_dispatch
    eng.runner.prefill_chunk_compute = on_compute
    eng._emit_first_token = on_emit
    return seen


BRANCHES = ("whole_copy", "short_copy", "nothing_valid", "short_under_prefix")


@pytest.mark.parametrize("chunk", [0, 32], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("branch", BRANCHES)
def test_swap_in_restores_the_valid_prefix_and_recomputes_the_rest(
        bundle, branch, chunk):
    cfg = bundle["cfg"]
    rng = np.random.RandomState(11)
    prompt = rng.randint(1, cfg.vocab_size, PROMPT).tolist()
    pinned = branch == "short_under_prefix"
    eng = _engine(bundle, chunk, prefix_cache=pinned)
    with chip_smoke.swaps_follow_the_clock():
        rid, served = _swapped_request(eng, prompt)
        req = eng._req(rid)
        shared = eng._shared_tokens(rid)
        assert shared == (SHARED if pinned else 0)
        ctx = req.context_tokens
        needed = ctx - 1
        valid = {"whole_copy": needed, "short_copy": 37, "nothing_valid": 0,
                 "short_under_prefix": SHARED + 21}[branch]
        if valid < needed:
            _overwrite_copy_past(eng, rid, valid, seed=chunk + len(branch))
        assert eng.reuse.restorable_tokens(rid) == valid
        ttfts = list(req.ttfts_us)
        history = list(req.token_history)
        seen = _record(eng, rid)
        resumes = eng.reuse.n_short_copy_resumes
        promptly = eng._swap_in(rid)
        table = eng._block_table(rid)
        if branch == "whole_copy":
            # the reference's swap-in: the whole context, nothing computed
            assert seen["restored"] == table[:-(-ctx // BS)]
            assert eng.reuse.n_short_copy_resumes == resumes
        else:
            assert promptly and req.state is ReqState.RUNNING
            assert eng.reuse.n_short_copy_resumes == resumes + 1
            upto = valid if valid > shared else shared
            assert seen["restored"] == table[shared // BS:-(-upto // BS)] \
                if valid > shared else seen["restored"] == []
            _drain(eng, served, lambda: req.prefill_remaining == 0
                   and req.state is ReqState.RUNNING)
            # the recomputation tiles [valid, needed) from the block
            # holding ``valid`` (the restored blocks seed its carry)
            pos = upto - upto % BS
            assert seen["chunks"], "nothing recomputed"
            for first, n in seen["chunks"]:
                assert first == pos
                pos += n
            assert pos == needed
            if chunk and needed - (upto - upto % BS) > chunk:
                assert len(seen["chunks"]) > 1
        _drain(eng, served)
    eng.shutdown()
    assert seen["first_tokens"] == 0 and req.ttfts_us == ttfts
    hist = prompt + served[rid]
    assert hist[:len(history)] == history
    assert len(served[rid]) == MAX_TOKENS
    checked = chip_smoke.check_history(bundle, hist,
                                       list(range(PROMPT, len(hist))))
    assert checked["generated"] == MAX_TOKENS


def test_contaminating_a_swapping_in_copy_leaves_the_restored_bytes(bundle):
    """A swap-in dispatched in flight (SWAPPING_IN) has already read its
    copy: the copy contaminated and its host bytes overwritten before
    the request is promoted, the pool holds the copy's bytes at dispatch
    for every position with KV, and the request decodes the dense
    argmax."""
    cfg = bundle["cfg"]
    prompt = np.random.RandomState(12).randint(1, cfg.vocab_size,
                                               PROMPT).tolist()
    eng = _engine(bundle, chunk=0, prefix_cache=False)
    with chip_smoke.swaps_follow_the_clock():
        rid, served = _swapped_request(eng, prompt)
        req = eng._req(rid)
        needed = req.context_tokens - 1
        n_blk = -(-needed // BS)
        cpu_ids = eng.reuse.mgr.request_block_ids(rid)[:n_blk]
        at_dispatch = eng.pools.cpu[:, :, cpu_ids].copy()
        decide = eng.swap.decide_async
        eng.swap.decide_async = lambda *a, **k: True
        assert eng._swap_in(rid) is False
        eng.swap.decide_async = decide
        assert req.state is ReqState.SWAPPING_IN
        assert eng.reuse._contaminate_one(float("inf"), requester=-1)
        assert eng.reuse.valid_tokens(rid) < needed
        eng.pools.cpu[:, :, cpu_ids] = 0x3f80     # bf16 1.0 everywhere
        _drain(eng, served, lambda: req.state is ReqState.RUNNING)
        gpu = eng.pools.gpu_full()[:, :, eng._block_table(rid)[:n_blk]]
        got = gpu.contiguous().view(torch.int16).numpy().view(np.uint16)
        L, two = got.shape[:2]
        got = got.reshape(L, two, n_blk * BS, -1)[:, :, :needed]
        want = at_dispatch.reshape(L, two, n_blk * BS, -1)[:, :, :needed]
        assert np.array_equal(got, want)
        _drain(eng, served)
    eng.shutdown()
    hist = prompt + served[rid]
    assert len(served[rid]) == MAX_TOKENS
    chip_smoke.check_history(bundle, hist, list(range(PROMPT, len(hist))))


def _sim_workload(cpu_blocks: int, trace_seed: int):
    convs = [Conversation(conv_id=i, arrival_s=0.0,
                          turns=[Turn((256, 288, 320, 352)[i % 4], 32),
                                 Turn((96, 128, 160)[i % 3], 32)],
                          think_time_s=0.05) for i in range(8)]
    cfg = EngineConfig(mode="sim", num_gpu_blocks=160,
                       num_cpu_blocks=cpu_blocks, max_running=8,
                       max_batch=8, block_size=BS,
                       seed=0).with_policy("fastswitch")
    return FastSwitchEngine(cfg, convs, trace=PriorityTrace(
        "random", 0.5, seed=trace_seed))


@settings(max_examples=20, deadline=None)
@given(st.integers(128, 512), st.integers(0, 10_000))
def test_short_copies_resume_under_any_storm(cpu_blocks, trace_seed):
    """Sim mode, chip_smoke's engine workload over a host pool of
    ``cpu_blocks`` blocks and a random priority storm: no swap-in
    restores a block past its copy's valid prefix, every swap-in over a
    short copy resumes it (RUNNING at once, counted) or leaves the
    request SWAPPED, and the sanitizer holds after every step."""
    eng = _sim_workload(cpu_blocks, trace_seed)
    core = eng.core
    seen = chip_smoke.watch_swap_ins(core)
    swap_in = core._swap_in
    outcomes = []

    def checked_swap_in(rid):
        req = core._req(rid)
        short = core.reuse.restorable_tokens(rid) < req.context_tokens - 1
        before = core.reuse.n_short_copy_resumes
        promptly = swap_in(rid)
        if short:
            resumed = core.reuse.n_short_copy_resumes - before
            outcomes.append((promptly, req.state, resumed))
        return promptly
    core._swap_in = checked_swap_in
    n = 0
    while not eng.done():
        eng.step()
        check_engine_invariants(core)
        n += 1
        assert n < 100_000
    eng.swap.shutdown()
    assert chip_smoke.past_valid_prefix(seen["restores"], BS) == []
    for promptly, state, resumed in outcomes:
        assert (promptly, state, resumed) in (
            (True, ReqState.RUNNING, 1), (False, ReqState.SWAPPED, 0))
    assert core.reuse.n_short_copy_resumes == sum(
        r for _, _, r in outcomes)


def test_a_resume_preempted_mid_recomputation_swaps_its_prefix_out(bundle):
    """A short copy's chunked recomputation preempted after its first
    chunk: the request swaps out the prefix it holds KV for (the copy is
    valid to it), goes back to SWAPPED with its pending token, resumes
    from that copy at its next swap-in, and decodes the dense argmax."""
    cfg = bundle["cfg"]
    prompt = np.random.RandomState(13).randint(1, cfg.vocab_size,
                                               PROMPT).tolist()
    eng = _engine(bundle, chunk=32, prefix_cache=False)
    with chip_smoke.swaps_follow_the_clock():
        rid, served = _swapped_request(eng, prompt)
        req = eng._req(rid)
        needed = req.context_tokens - 1
        assert len(req.token_history) == req.context_tokens
        _overwrite_copy_past(eng, rid, 37, seed=5)
        seen = _record(eng, rid)
        assert eng._swap_in(rid) and req.prefill_remaining > 32
        eng.step()                      # the recomputation's first chunk
        (first, n), = seen["chunks"]
        assert (first, n) == (32, 32)
        assert req.prefill_remaining == needed - 64
        eng._preempt(rid)
        assert req.state is ReqState.SWAPPED
        assert req.prefill_remaining == 0 and not req.prefill_is_resume
        assert req.resume_tokens == 0 and req.context_tokens == needed + 1
        for t in list(eng.swap.ongoing_swap_out):
            if t.future is not None:
                t.future.result()
        # the increment [37, 64) went out: the copy is valid to 64
        assert eng.reuse.restorable_tokens(rid) == 64
        seen["restored"].clear()
        seen["chunks"].clear()
        assert eng._swap_in(rid) and eng.reuse.n_short_copy_resumes == 2
        table = eng._block_table(rid)
        assert seen["restored"] == table[:4]
        _drain(eng, served, lambda: req.prefill_remaining == 0)
        assert seen["chunks"][0][0] == 64
        assert sum(n for _, n in seen["chunks"]) == needed - 64
        _drain(eng, served)
    eng.shutdown()
    assert seen["first_tokens"] == 0
    hist = prompt + served[rid]
    assert len(served[rid]) == MAX_TOKENS
    chip_smoke.check_history(bundle, hist, list(range(PROMPT, len(hist))))
