"""Real-mode bucketed chunked prefill in the port (DESIGN.md §5): the
cases of ``tests/test_chunked_prefill.py`` against
``repro_torch.kernels.ops`` and ``repro_torch.core.decode_runner``, and
the runner's chunked prefill run through both packages.

Covers the three tentpole guarantees:
  * the position-masked chunk forward is BIT-EXACT with the monolithic
    ``prefill_kv`` in its carry KV for any chunking, and in its last
    logits among chunkings; the monolithic last logits within 4.77e-7
    (the two unembed products have other shapes);
  * the DecodeRunner prefill state machine (begin / chunk / finish /
    abort) writes each KV row exactly where the block table says and
    nowhere else, across random chunk/abort interleavings (Hypothesis);
  * prompt-length variety compiles O(log max_len) prefill variants, and
    the engine emits decode tokens BETWEEN the chunks of a long prompt's
    prefill (no decode starvation, bounded per-row TBT gap).
"""
import math
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.core.decode_runner import DecodeRequestView, DecodeRunner
from repro_torch.kernels import ops
from repro_torch.models.paged import prefill_kv
from torch_parity import assert_histories_agree, smoke_bundles
from torch_threads import one_torch_thread  # noqa: F401

BS = 16


@pytest.fixture(scope="module")
def model():
    """The reduced qwen2-1.5b with the reference fixture's weights."""
    return smoke_bundles()[1]


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _mk_pool(cfg, nb, fill=0.0):
    shape = (cfg.n_layers, 2, nb, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    return torch.full(shape, fill, dtype=torch.bfloat16)


def _ref(model, toks):
    """Monolithic reference: (last_logits, k, v) for the token list."""
    lg, k, v = prefill_kv(model["params"], torch.tensor([toks]),
                          cfg=model["cfg"])
    return lg, k, v


# how far a chunked prefill's last logits lie from the monolithic
# ``prefill_kv``'s on this file's prompts: 2**-21, one fp32 ulp at
# |x| in [4, 8), the largest difference of two fp32 sums of 64 products
# taken in other orders (see test_prefill_chunk_bitexact_vs_monolithic)
MONOLITHIC_GAP = 2.0 ** -21


def _near_monolithic(got, want):
    """Every logit of ``got`` within ``MONOLITHIC_GAP`` of ``want``'s, and
    the same argmax."""
    gap = float((got.float() - want.float()).abs().max())
    assert gap <= MONOLITHIC_GAP, f"largest gap {gap}"
    assert int(torch.argmax(got)) == int(torch.argmax(want))
    return gap


# ---------------------------------------------------------------------------
# chunk forward bit-exactness
# ---------------------------------------------------------------------------


SPLITS = [(44,), (16, 16, 12), (32, 12), (16, 28), (5, 16, 16, 7)]


def _chunked(model, toks, splits):
    kc = vc = None
    pos = 0
    for n in splits:
        lg, kc, vc, _, _ = ops.prefill_chunk(
            model["params"], toks[pos:pos + n], kc, vc, pos,
            cfg=model["cfg"], block_size=BS)
        pos += n
    assert pos == len(toks)
    return lg, kc[:, :pos], vc[:, :pos]


@pytest.mark.parametrize("splits", SPLITS)
def test_prefill_chunk_bitexact_vs_monolithic(model, splits):
    """Any chunking of the prompt — including a non-aligned FIRST chunk
    (the wrapper itself has no alignment requirement; only the pool
    insert does) and ragged final chunks — reproduces the monolithic
    forward's carry KV bit for bit, and the single chunk's last-position
    logits bit for bit (every chunking unembeds one row: its last).

    The monolithic ``prefill_kv`` unembeds every position and takes the
    last row (``models/paged.py::prefill_kv``), a (T, d) x (d, V) product
    where the chunk's is (1, d) x (d, V): the two products sum in other
    orders, and their last rows differ by up to 4.77e-7 (2**-21;
    ``MONOLITHIC_GAP``) with the same argmax, as the reference's do
    (up to 4.5e-7).  Those logits are held to that."""
    toks = np.random.RandomState(0).randint(
        1, model["cfg"].vocab_size, 44).tolist()
    lg_ref, k_ref, v_ref = _ref(model, toks)
    lg, kc, vc = _chunked(model, toks, splits)
    assert torch.equal(kc, k_ref)
    assert torch.equal(vc, v_ref)
    lg_one, _, _ = _chunked(model, toks, SPLITS[0])
    assert torch.equal(lg, lg_one), "last-position logits diverged"
    _near_monolithic(lg, lg_ref)


def test_prefill_chunk_carry_growth_is_transparent(model):
    """The pow2 carry growth between chunks never perturbs earlier KV."""
    toks = np.random.RandomState(1).randint(
        1, model["cfg"].vocab_size, 70).tolist()
    _, k_ref, v_ref = _ref(model, toks)
    kc = vc = None
    pos = 0
    buckets = []
    for n in (16, 16, 16, 16, 6):       # carry crosses 32 -> 64 -> 128
        _, kc, vc, _, _ = ops.prefill_chunk(
            model["params"], toks[pos:pos + n], kc, vc, pos,
            cfg=model["cfg"], block_size=BS)
        buckets.append(kc.shape[1])
        pos += n
    assert len(set(buckets)) > 1, "test never grew the carry"
    assert torch.equal(kc[:, :pos], k_ref)
    assert torch.equal(vc[:, :pos], v_ref)


# ---------------------------------------------------------------------------
# runner state machine: KV lands exactly where the block table says
# ---------------------------------------------------------------------------


def _check_pool_rows(model, pool, block_ids, toks, k_ref, v_ref,
                     sentinel, trash):
    """Every token's KV sits in its block-table slot; every block outside
    the table (and != trash) is untouched sentinel."""
    cfg = model["cfg"]
    bs = BS
    for t in range(len(toks)):
        blk, off = block_ids[t // bs], t % bs
        assert torch.equal(pool[:, 0, blk, off], k_ref[:, t]), f"tok {t}"
        assert torch.equal(pool[:, 1, blk, off], v_ref[:, t]), f"tok {t}"
    used = set(block_ids[:(len(toks) + bs - 1) // bs]) | {trash}
    for b in range(pool.shape[2]):
        if b not in used:
            assert bool(torch.all(pool[:, :, b] == sentinel)), \
                f"stray write into block {b}"


def test_runner_chunked_state_machine_matches_monolithic(model):
    """begin/chunk/chunk/finish: pool rows == monolithic KV, first token
    == greedy argmax of the last-position logits, no stray writes."""
    cfg = model["cfg"]
    nb, trash, sentinel = 12, 11, 3.0
    pool = _mk_pool(cfg, nb, fill=sentinel)
    runner = DecodeRunner(model, block_size=BS, trash_block=trash)
    toks = np.random.RandomState(2).randint(1, cfg.vocab_size, 40).tolist()
    lg_ref, k_ref, v_ref = _ref(model, toks)
    hist = list(toks)
    block_ids = [5, 2, 7]                        # deliberately non-identity
    view = DecodeRequestView(0, block_ids, hist)
    total = runner.prefill_begin(view, emit_first=True)
    assert total == 40
    for n in (16, 16, 8):
        staged = runner.prefill_chunk_compute(0, n)
        pool = runner.prefill_chunk_insert(0, pool, staged)
    runner.prefill_finish(0)
    assert hist[-1] == int(torch.argmax(lg_ref))
    assert runner._prefills == {}
    _check_pool_rows(model, pool, block_ids, toks, k_ref, v_ref,
                     sentinel, trash)


def test_runner_prefill_abort_and_restart(model):
    """Aborting mid-prefill drops the carry; a fresh begin reprocesses
    from scratch and converges to the same pool content and first token."""
    cfg = model["cfg"]
    nb, trash, sentinel = 10, 9, 3.0
    pool = _mk_pool(cfg, nb, fill=sentinel)
    runner = DecodeRunner(model, block_size=BS, trash_block=trash)
    toks = np.random.RandomState(3).randint(1, cfg.vocab_size, 33).tolist()
    lg_ref, k_ref, v_ref = _ref(model, toks)
    hist = list(toks)
    view = DecodeRequestView(0, [0, 1, 2], hist)
    runner.prefill_begin(view, emit_first=True)
    staged = runner.prefill_chunk_compute(0, 16)
    pool = runner.prefill_chunk_insert(0, pool, staged)
    runner.prefill_abort(0)
    assert runner.stats.prefill_aborts == 1
    assert len(hist) == 33                       # no token emitted
    # restart from scratch
    runner.prefill_begin(view, emit_first=True)
    while (n := min(16, runner.prefill_pending(0))) > 0:
        staged = runner.prefill_chunk_compute(0, n)
        pool = runner.prefill_chunk_insert(0, pool, staged)
    runner.prefill_finish(0)
    assert hist[-1] == int(torch.argmax(lg_ref))
    _check_pool_rows(model, pool, [0, 1, 2], toks, k_ref, v_ref,
                     sentinel, trash)


def test_chunked_prefill_property_random_interleavings(model):
    """Hypothesis property: random chunk sizes and
    abort/restart points never lose or double-write KV rows — the final
    pool holds exactly the monolithic KV in the request's blocks, every
    other block keeps its sentinel, and the state machine ends empty."""
    pytest.importorskip("hypothesis",
                        reason="dev-only dep; see requirements-dev.txt")
    from hypothesis import given, settings, strategies as st

    cfg = model["cfg"]
    nb, trash, sentinel = 10, 9, 3.0
    refs = {}

    @settings(max_examples=8, deadline=None)
    @given(st.data())
    def run(data):
        total = data.draw(st.integers(4, 72), label="total")
        toks = np.random.RandomState(total).randint(
            1, cfg.vocab_size, total).tolist()
        if total not in refs:
            refs[total] = _ref(model, toks)
        lg_ref, k_ref, v_ref = refs[total]
        pool = _mk_pool(cfg, nb, fill=sentinel)
        runner = DecodeRunner(model, block_size=BS, trash_block=trash)
        hist = list(toks)
        view = DecodeRequestView(0, [4, 1, 6, 2, 7], hist)
        runner.prefill_begin(view, emit_first=True)
        aborts = 0
        while (rem := runner.prefill_pending(0)) > 0:
            # mirror the engine's chunk rounding: non-final chunks are
            # block-size multiples
            n = min(data.draw(st.integers(1, 48), label="chunk"), rem)
            if n < rem:
                n -= n % BS
                if n == 0:
                    n = min(BS, rem)
            staged = runner.prefill_chunk_compute(0, n)
            pool = runner.prefill_chunk_insert(0, pool, staged)
            if (aborts < 2 and runner.prefill_pending(0) > 0
                    and data.draw(st.integers(0, 3), label="abort") == 0):
                runner.prefill_abort(0)
                aborts += 1
                runner.prefill_begin(view, emit_first=True)
        runner.prefill_finish(0)
        assert hist[-1] == int(torch.argmax(lg_ref))
        assert runner._prefills == {}
        _check_pool_rows(model, pool, [4, 1, 6, 2, 7], toks, k_ref, v_ref,
                         sentinel, trash)

    run()


def test_seeded_carry_resumes_from_pool_prefix(model):
    """Re-admission with a reused prefix: ``prefill_begin`` seeds the
    carry from KV already resident in the pool and processes ONLY the
    tail beyond the block-aligned reused prefix — final pool content and
    first token stay bit-exact with the monolithic forward."""
    cfg = model["cfg"]
    nb, trash, sentinel = 10, 9, 3.0
    pool = _mk_pool(cfg, nb, fill=sentinel)
    runner = DecodeRunner(model, block_size=BS, trash_block=trash)
    toks = np.random.RandomState(4).randint(1, cfg.vocab_size, 48).tolist()
    lg_ref, k_ref, v_ref = _ref(model, toks)
    block_ids = [3, 0, 5]
    # simulate the reuse swap-in: the prefix KV (first 2 pages) is
    # already resident in the pool
    pool = ops.insert_prefill(pool, k_ref[:, :32], v_ref[:, :32],
                              block_ids[:2], BS)
    hist = list(toks)
    view = DecodeRequestView(0, block_ids, hist)
    total = runner.prefill_begin(view, emit_first=True, reused_tokens=35,
                                 pool=pool)
    assert total == 48 - 32            # 35 rounds down to the page floor
    assert runner.prefill_pending(0) == 16
    staged = runner.prefill_chunk_compute(0, 16)
    pool = runner.prefill_chunk_insert(0, pool, staged)
    runner.prefill_finish(0)
    assert hist[-1] == int(torch.argmax(lg_ref))
    _check_pool_rows(model, pool, block_ids, toks, k_ref, v_ref,
                     sentinel, trash)


# ---------------------------------------------------------------------------
# jit-cache bound: prompt-length sweep
# ---------------------------------------------------------------------------


def test_prefill_jit_cache_bounded_over_prompt_sweep(model):
    """Acceptance: 40 distinct prompt lengths through the
    runner's (now bucketed) prefill compile O(log max_len) chunk-forward
    variants — the legacy exact-shape ``prefill_kv`` compiled one per
    length."""
    cfg = model["cfg"]
    max_len = 200
    nb = max_len // BS + 3
    runner = DecodeRunner(model, block_size=BS, trash_block=nb - 1)
    pool = _mk_pool(cfg, nb)
    rng = np.random.RandomState(0)
    lens = rng.choice(np.arange(3, max_len), size=40, replace=False)
    c0 = ops.prefill_chunk_cache_size()
    for n in lens:
        hist = rng.randint(1, cfg.vocab_size, int(n)).tolist()
        view = DecodeRequestView(0, list(range(len(hist) // BS + 1)), hist)
        pool = runner.prefill(view, pool, emit_first=True)
    grew = ops.prefill_chunk_cache_size() - c0
    bound = math.ceil(math.log2(max_len)) + 1
    assert grew <= bound, \
        f"{grew} compiled prefill variants for 40 lengths (bound {bound})"


# ---------------------------------------------------------------------------
# engine interleaving: no decode starvation during a long prefill
# ---------------------------------------------------------------------------


def _interleave_engine(model, chunked, prompt_tokens, chunk=64):
    from repro_torch.core import EngineConfig, FastSwitchEngine
    from repro_torch.core.policies import POLICIES
    from repro_torch.data.priority import PriorityTrace
    from repro_torch.data.sharegpt import Conversation, Turn
    # small block groups: the default 60-block groups would eat the tiny
    # pool after two admissions and serialize the whole scenario
    pol = replace(POLICIES["fastswitch"], initial_group_blocks=4)
    if chunked:
        pol = replace(pol, chunked_prefill_tokens=chunk)
    convs = [Conversation(conv_id=i, arrival_s=0.0,
                          turns=[Turn(8, 40)], think_time_s=0.1)
             for i in range(4)]
    # arrival 0.0: all five admit in the cold first iteration (no batch
    # bucket compiled yet -> no admission hold), so the decode batch and
    # the long prefill genuinely overlap
    convs.append(Conversation(conv_id=4, arrival_s=0.0,
                              turns=[Turn(prompt_tokens, 3)],
                              think_time_s=0.1))
    cfg = EngineConfig(mode="real",
                       num_gpu_blocks=prompt_tokens // 16 + 24,
                       num_cpu_blocks=512, max_running=8, max_batch=8,
                       block_size=16, policy=pol)
    return FastSwitchEngine(cfg, convs, trace=PriorityTrace(),
                            model_bundle=model)


def test_chunked_prefill_interleaves_decode_with_bounded_tbt(model):
    """With a 4-row decode batch and a long-prompt
    admission, decode tokens ARE emitted between the prompt's chunks and
    every row keeps emitting in (nearly) every chunk iteration — the
    per-row TBT gap is bounded at ~1 iteration, i.e. no decode
    starvation while the 512-token prompt prefills."""
    prompt = 512
    eng = _interleave_engine(model, chunked=True, prompt_tokens=prompt)
    reqs = {}
    per_row = {r: 0 for r in range(4)}
    chunk_iters = 0
    for _ in range(5000):
        if eng.done():
            break
        before = {r: req.generated for r, req in eng.sched.requests.items()
                  if r < 4}
        reqs.update(eng.sched.requests)
        eng.step()
        long_req = reqs.get(4)
        if long_req is not None and long_req.prefill_remaining > 0:
            chunk_iters += 1
            for r, req in eng.sched.requests.items():
                if r < 4:
                    per_row[r] += req.generated - before.get(r, req.generated)
    assert eng.done()
    # the admission iteration itself is not counted (the request enters
    # ``reqs`` post-step), hence the -2
    assert chunk_iters >= prompt // 64 - 2, "prefill never chunked"
    for r, emitted in per_row.items():
        assert emitted >= chunk_iters - 1, \
            f"row {r} starved: {emitted} tokens over {chunk_iters} " \
            f"chunk iterations (TBT gap > 2 iterations)"


def test_monolithic_prefill_has_no_interleave_window(model):
    """Contrast baseline: the monolithic real-mode path completes the
    whole 512-token prefill inside the admission iteration —
    ``prefill_remaining`` is never observable, so zero decode tokens can
    interleave with the prompt processing."""
    prompt = 512
    eng = _interleave_engine(model, chunked=False, prompt_tokens=prompt)
    reqs = {}
    window = 0
    for _ in range(5000):
        if eng.done():
            break
        reqs.update(eng.sched.requests)
        eng.step()
        for req in eng.sched.requests.values():
            window += req.prefill_remaining > 0
    assert eng.done()
    assert 4 in reqs and reqs[4].generated == 3     # the long conv ran
    assert window == 0, "monolithic prefill unexpectedly chunked"


# ---------------------------------------------------------------------------
# both packages, the same scenario
# ---------------------------------------------------------------------------


def test_runner_chunked_prefill_matches_reference(model):
    """Five prompts (40 to 72 tokens) through both packages' runners, each
    in chunks of 16 with an abort and restart after the first: every
    history (the prompt and its first token) equal, or the first token a
    near-tie of the port's logits."""
    import jax.numpy as jnp

    from repro.core.decode_runner import DecodeRequestView as JaxView
    from repro.core.decode_runner import DecodeRunner as JaxRunner
    jb, _ = smoke_bundles()
    cfg = model["cfg"]
    nb, trash = 12, 11
    shape = (cfg.n_layers, 2, nb, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    hists = {"ours": {}, "ref": {}}
    for name, runner, view_cls, pool in (
            ("ours", DecodeRunner(model, block_size=BS, trash_block=trash),
             DecodeRequestView, _mk_pool(cfg, nb)),
            ("ref", JaxRunner(jb, block_size=BS, trash_block=trash),
             JaxView, jnp.zeros(shape, jnp.bfloat16))):
        for i, n in enumerate((40, 47, 56, 64, 72)):
            hist = np.random.RandomState(10 + i).randint(
                1, cfg.vocab_size, n).tolist()
            view = view_cls(i, [5, 2, 7, 0, 9], hist)
            runner.prefill_begin(view, emit_first=True)
            pool = runner.prefill_chunk_insert(
                i, pool, runner.prefill_chunk_compute(i, 16))
            runner.prefill_abort(i)
            runner.prefill_begin(view, emit_first=True)
            while (k := min(16, runner.prefill_pending(i))) > 0:
                pool = runner.prefill_chunk_insert(
                    i, pool, runner.prefill_chunk_compute(i, k))
            runner.prefill_finish(i)
            runner.release(i)
            hists[name][i] = hist
    assert all(len(h) == n + 1 for h, n in zip(hists["ours"].values(),
                                               (40, 47, 56, 64, 72)))
    assert_histories_agree(model, hists["ours"], hists["ref"])
