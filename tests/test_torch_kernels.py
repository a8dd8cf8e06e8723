"""repro_torch's kernel modules against the JAX package's (CPU).

On the CPU the port's wrappers take their plain PyTorch versions; the
reference's Pallas kernels run in interpret mode, as its own tests run
them.  Inputs are made with numpy from a seed and handed to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import block_copy as jax_bc
from repro.kernels import ops as jax_ops
from repro.kernels.paged_attention import paged_attention as jax_paged_attention
from repro_torch.kernels import block_copy as bc
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from torch_threads import one_torch_thread  # noqa: E402,F401

# fp32: both sides take exact fp32 products and sum in another order
# (online softmax over tiles vs one softmax), 1e-5 as tests/test_kernels.py;
# bf16: outputs round once to bf16 (rel. 2^-8) after those sums, 2e-2
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _attention_inputs(seed, B, Hq, Hkv, D, bs, npages, trash_rows=()):
    rng = np.random.default_rng(seed)
    nb = npages * B + 3
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    bt = rng.permutation(nb - 1)[:B * npages].reshape(B, npages)
    bt = bt.astype(np.int32)
    ctx = np.linspace(1, npages * bs, B).astype(np.int32)
    for r in trash_rows:
        bt[r] = nb - 1                 # the trash block of a freed row
        ctx[r] = 1
    return q, kp, vp, bt, ctx


def _both(q, kp, vp, bt, ctx, dtype, ppcb):
    D = q.shape[-1]
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jax_paged_attention(jnp.asarray(q, jd), jnp.asarray(kp, jd),
                              jnp.asarray(vp, jd), jnp.asarray(bt),
                              jnp.asarray(ctx), D ** -0.5,
                              pages_per_compute_block=ppcb)
    launches = pa.paged_attention.launches
    out = pa.paged_attention(torch.from_numpy(q).to(td),
                             torch.from_numpy(kp).to(td),
                             torch.from_numpy(vp).to(td),
                             torch.from_numpy(bt), torch.from_numpy(ctx),
                             D ** -0.5, ppcb)
    assert pa.paged_attention.launches == launches   # CPU: plain version
    return out.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("B,Hq,Hkv,D,bs,npages", [
    (1, 4, 4, 64, 16, 2),      # MHA
    (3, 8, 2, 64, 16, 4),      # GQA group=4
    (2, 16, 16, 128, 16, 3),   # MHA wide head
    (2, 12, 2, 128, 32, 2),    # qwen2-like, bigger block
    (1, 8, 1, 64, 16, 8),      # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_plain_matches_reference(B, Hq, Hkv, D, bs, npages,
                                                 dtype):
    trash = (B - 1,) if B > 1 else ()
    inputs = _attention_inputs(B * 10 + npages, B, Hq, Hkv, D, bs, npages,
                               trash)
    out, ref = _both(*inputs, dtype, 1)
    np.testing.assert_allclose(out, ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("ppcb", [1, 2, 4])
@pytest.mark.parametrize("npages", [3, 5, 8])
def test_paged_attention_ragged_tiles_and_zero_context(ppcb, npages):
    """A ragged final page tile, a ctx == 0 row (the uniform mean of V
    over the padded table, as the reference's -1e30 mask gives) and a
    trash-page row."""
    q, kp, vp, bt, ctx = _attention_inputs(npages, 4, 8, 2, 64, 16, npages,
                                           trash_rows=(3,))
    ctx[0] = 0
    out, ref = _both(q, kp, vp, bt, ctx, "float32", ppcb)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert np.all(np.isfinite(out))


def _finite_bits(rng, shape):
    """Random bf16 bit patterns with the exponent's top bit clear: finite
    values (the reference's copies may canonicalise NaN payloads)."""
    return rng.integers(0, 2 ** 16, shape, dtype=np.uint16) & 0xBFFF


def _run_inputs(seed, C, n_src, n_dst, E):
    rng = np.random.default_rng(seed)
    return _finite_bits(rng, (C, n_src, E)), _finite_bits(rng, (C, n_dst, E))


def _bf16(bits):
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("runs", [
    [(0, 4), (10, 2)],
    [(3, 1)],
    [(0, 8), (8, 8), (20, 4)],            # 3 runs: one zero-length pad run
    [(30, 1), (2, 3), (7, 2), (12, 5), (25, 2)],
])
@pytest.mark.parametrize("direction", ["gather", "scatter"])
def test_run_copy_byte_equal_with_reference(runs, direction):
    """Both directions of the run copy, byte for byte, with the pow2 run
    padding of ``_pad_runs``; destination blocks no run names keep their
    (random) bytes."""
    src_s, dst_s, lens, _, n_slab, run_blocks = ops._pad_runs(runs)
    C, E = 6, 64
    if direction == "gather":
        src, dst = _run_inputs(1, C, 40, n_slab, E)
        a, b = src_s, dst_s
        ref = jax_bc.block_gather_runs(
            jnp.asarray(src.view(jnp.bfloat16)), jnp.asarray(dst.view(jnp.bfloat16)),
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(lens),
            run_blocks=run_blocks)
        out = bc.block_gather_runs(_bf16(src), _bf16(dst),
                                   torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(lens), run_blocks)
    else:
        src, dst = _run_inputs(2, C, n_slab, 40, E)
        a, b = dst_s, src_s
        ref = jax_bc.block_scatter_runs(
            jnp.asarray(src.view(jnp.bfloat16)), jnp.asarray(dst.view(jnp.bfloat16)),
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(lens),
            run_blocks=run_blocks)
        out = bc.block_scatter_runs(_bf16(src), _bf16(dst),
                                    torch.from_numpy(a), torch.from_numpy(b),
                                    torch.from_numpy(lens), run_blocks)
    np.testing.assert_array_equal(_bits(out),
                                  np.asarray(ref).view(np.uint16))


@pytest.mark.parametrize("runs", [[(3, 5), (20, 1), (9, 7)], [(0, 16)]])
def test_swap_gather_scatter_ops_byte_equal(runs):
    """``ops.gather_swap_runs`` / ``scatter_swap_runs`` on a 6-D pool:
    the slab and the scattered pool equal the reference's bytes."""
    rng = np.random.default_rng(len(runs))
    shape = (2, 2, 40, 16, 2, 64)
    bits = _finite_bits(rng, shape)
    jslab, jtotal = jax_ops.gather_swap_runs(
        jnp.asarray(bits.view(jnp.bfloat16)), runs)
    tslab, ttotal = ops.gather_swap_runs(_bf16(bits), runs)
    assert ttotal == jtotal
    np.testing.assert_array_equal(_bits(tslab),
                                  np.asarray(jslab).view(np.uint16))
    dst_runs, off = [], 1                  # disjoint, other places
    for _, n in runs:
        dst_runs.append((off, n))
        off += n + 3
    bits2 = _finite_bits(rng, shape)
    jpool = jax_ops.scatter_swap_runs(jnp.asarray(bits2.view(jnp.bfloat16)),
                                      jslab, dst_runs)
    tpool = ops.scatter_swap_runs(_bf16(bits2.copy()), tslab, dst_runs)
    np.testing.assert_array_equal(_bits(tpool),
                                  np.asarray(jpool).view(np.uint16))


@pytest.mark.parametrize("runs,n,chunk", [
    ([(0, 4), (10, 2)], 5, 3),
    ([(5, 1), (7, 9), (30, 3)], 11, 4),
    ([(2, 6)], 0, 0),
])
def test_run_helpers_match_reference(runs, n, chunk):
    assert bc.runs_to_indices(runs) == jax_bc.runs_to_indices(runs)
    assert bc.trim_runs(runs, n) == jax_bc.trim_runs(runs, n)
    assert bc.split_runs(runs, chunk) == jax_bc.split_runs(runs, chunk)
    for got, want in zip(ops._pad_runs(runs), jax_ops._pad_runs(runs)):
        np.testing.assert_array_equal(got, want)
    total = sum(k for _, k in runs)
    assert ops.slab_bucket_blocks(total) == jax_ops.slab_bucket_blocks(total)
    assert ops._next_pow2(total) == jax_ops._next_pow2(total)


def test_insert_prefill_and_seed_carry_match_reference():
    rng = np.random.default_rng(4)
    L, nb, bs, H, D = 2, 12, 16, 2, 64
    pool_bits = _finite_bits(rng, (L, 2, nb, bs, H, D))
    k = rng.standard_normal((L, 3 * bs, H, D)).astype(np.float32)
    v = rng.standard_normal((L, 3 * bs, H, D)).astype(np.float32)
    blocks = [7, 2, nb - 1]
    jpool = jax_ops.insert_prefill(jnp.asarray(pool_bits.view(jnp.bfloat16)),
                                   jnp.asarray(k, jnp.bfloat16),
                                   jnp.asarray(v, jnp.bfloat16), blocks, bs)
    tpool = ops.insert_prefill(_bf16(pool_bits.copy()),
                               torch.from_numpy(k).to(torch.bfloat16),
                               torch.from_numpy(v).to(torch.bfloat16),
                               blocks, bs)
    np.testing.assert_array_equal(_bits(tpool),
                                  np.asarray(jpool).view(np.uint16))
    jk, jv = jax_ops.seed_prefill_carry(jpool, [7, 2, 5], 3 * bs,
                                        trash=nb - 1)
    tk, tv = ops.seed_prefill_carry(tpool, [7, 2, 5], 3 * bs, trash=nb - 1)
    np.testing.assert_array_equal(_bits(tk), np.asarray(jk).view(np.uint16))
    np.testing.assert_array_equal(_bits(tv), np.asarray(jv).view(np.uint16))


@pytest.mark.parametrize("ppcb", [1, 2])
def test_paged_attention_block_ids_follow_the_tpu_index_rule(ppcb):
    """Table entries outside [0, nb) on a 6-block pool: the reference's
    index map counts a negative id from the end of the pool, then clamps
    into [0, nb) (-3 reads block 3, 9 block 5, -9 block 0); the padding
    page 0 is read by the ctx-0 row."""
    rng = np.random.default_rng(6)
    nb, bs, Hq, Hkv, D = 6, 16, 4, 2, 64
    q = rng.standard_normal((4, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    bt = np.array([[-3, 1, 9], [9, -9, -1], [2, -3, -9], [-9, 9, -3]],
                  np.int32)
    ctx = np.array([40, 33, 17, 0], np.int32)
    out, ref = _both(q, kp, vp, bt, ctx, "float32", ppcb)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the CUDA kernel's numerics and partition, emulated on the CPU
# ---------------------------------------------------------------------------

# chip_smoke.py's and the card tests' per-element gate on bf16 outputs
ATTN_ATOL, ATTN_RTOL = 1e-3, 2 ** -7


def _pv_emulated(q, k, v, bt, ctx, scale, p_mode):
    """Each row's attention as the kernel's tensor cores compute it: fp32
    scores of bf16 q.k, fp32 p and l, and P.V with bf16 V and P rounded
    once to bf16 ("round"), split into hi = bf16(p) and lo = bf16(p - hi)
    ("split"), into three such terms ("split3", the kernel's), or kept in
    fp32 ("fp32"); the output rounded to bf16."""
    B, Hq, D = q.shape
    _, bs, Hkv, _ = k.shape
    out = torch.empty(B, Hq, D)
    for b in range(B):
        n = int(ctx[b])
        kk = k[bt[b].long()].reshape(-1, Hkv, D)[:n].float()
        vv = v[bt[b].long()].reshape(-1, Hkv, D)[:n].float()
        s = torch.einsum("hgd,thd->hgt",
                         q[b].reshape(Hkv, Hq // Hkv, D).float(), kk) * scale
        p = torch.exp(s - s.amax(-1, keepdim=True))
        terms, rest = [], p
        for _ in range({"round": 1, "split": 2, "split3": 3}.get(p_mode, 0)):
            terms.append(rest.bfloat16().float())
            rest = rest - terms[-1]
        pp = sum(terms) if terms else p
        out[b] = (torch.einsum("hgt,thd->hgd", pp, vv)
                  / p.sum(-1, keepdim=True)).reshape(Hq, D)
    return out.bfloat16()


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_tolerance_fails_rounded_p_and_passes_split_p(seed):
    """The kernel gate (1e-3 + 2^-7 |ref| per element) on rows of 1-64
    tokens at qwen2-1.5b's head shape, bf16 N(0, 1): P rounded once to
    bf16 before P.V misses it; P split into two or three bf16 terms, or
    P.V in fp32, stays far inside it.  Two terms leave 2^-18 p and flip
    the bf16 rounding of ~0.2 % of outputs against fp32 P.V; three terms
    carry p's 24 bits and flip next to none."""
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, D, bs, n_pages = 64, 12, 2, 128, 16, 4
    nb = B * n_pages + 1
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).bfloat16()
               for shape in ((B, Hq, D), (nb, bs, Hkv, D), (nb, bs, Hkv, D)))
    bt = torch.from_numpy(rng.permutation(nb)[:B * n_pages]
                          .reshape(B, n_pages).astype(np.int32))
    ctx = torch.arange(1, B + 1, dtype=torch.int32)
    ref = pa.paged_attention_plain(q, k, v, bt, ctx, D ** -0.5).float()

    def excess(p_mode):
        out = _pv_emulated(q, k, v, bt, ctx, D ** -0.5, p_mode).float()
        return float(((out - ref).abs() - ATTN_RTOL * ref.abs()).max())
    assert excess("round") > ATTN_ATOL
    for p_mode in ("split", "split3", "fp32"):
        assert excess(p_mode) < ATTN_ATOL / 100
    # the share of outputs whose bf16 rounding differs from fp32 P.V's
    fp32 = _pv_emulated(q, k, v, bt, ctx, D ** -0.5, "fp32")
    flips = {p_mode: float((_pv_emulated(q, k, v, bt, ctx, D ** -0.5, p_mode)
                            != fp32).float().mean())
             for p_mode in ("split", "split3")}
    assert flips["split"] > 5e-4 and flips["split3"] < 5e-5


@pytest.mark.parametrize("B,Hkv,n_pages,bs", [
    (8, 2, 64, 16),          # the engine's bucket
    (8, 2, 128, 16),
    (32, 2, 128, 16),        # chip_smoke's B 32 row
    (1, 1, 7, 16),
    (3, 2, 5, 32),
    (2, 4, 3000, 16),        # past MAX_CHUNK_PAGES in one split
    (5, 2, 9, 48),           # 64 and bs share no power of two past 16
    (200, 2, 64, 16),        # 400 CTAs fill 396 resident slots
])
def test_split_plan_tiles_the_padded_table(B, Hkv, n_pages, bs):
    """split_plan reads shapes only; its chunks are whole 64-token steps
    and whole pages, at most MAX_CHUNK_PAGES, tile the padded table from
    token 0 with no gap or overlap, and every split starts inside it."""
    import inspect
    assert list(inspect.signature(pa.split_plan).parameters) == \
        ["B", "Hkv", "n_tokens", "bs", "num_sms"]
    n_tokens = n_pages * bs
    n_splits, chunk = pa.split_plan(B, Hkv, n_tokens, bs)
    assert (n_splits, chunk) == pa.split_plan(B, Hkv, n_tokens, bs)
    assert chunk % pa.STEP == 0 and chunk % bs == 0
    assert chunk // bs <= pa.MAX_CHUNK_PAGES
    spans = [(s * chunk, min((s + 1) * chunk, n_tokens))
             for s in range(n_splits)]
    assert spans[0][0] == 0 and spans[-1][1] == n_tokens
    assert all(a < e for a, e in spans)
    assert all(e == a2 for (_, e), (a2, _) in zip(spans, spans[1:]))
    if B * Hkv >= pa.CTAS_PER_SM * pa.H100_SMS:
        assert n_splits == 1


def test_split_plan_gives_one_split_where_the_rows_fill_the_card():
    slots = pa.CTAS_PER_SM * pa.H100_SMS
    assert pa.split_plan(slots // 2, 2, 2048, 16) == (1, 2048)
    assert pa.split_plan(slots // 2 - 1, 2, 2048, 16)[0] > 1
    assert pa.split_plan(8, 2, 1024, 16, num_sms=4) == (1, 1024)
    assert pa.split_plan(8, 2, 1024, 16) == (16, 64)
    assert pa.split_plan(32, 2, 2048, 16) == (11, 192)


def _split_kv_emulated(q, k, v, bt, ctx, scale, ppcb):
    """The kernel's partition and merge in fp32 on the CPU: each split of
    ``split_plan`` walks its chunk of the padded table up to the row's
    walk (min(ctx, table), the whole table when ctx <= 0) with -1e30 at
    positions >= ctx; an empty split gives (m, l) = (-inf, 0); the splits
    merge in order as M = max m_s, O = sum e^(m_s - M) O_s / max(sum
    e^(m_s - M) l_s, 1e-30)."""
    B, Hq, D = q.shape
    nb, bs, Hkv, _ = k.shape
    npp = pa._padded_pages(bt.shape[1], ppcb)
    n_tab = npp * bs
    n_splits, chunk = pa.split_plan(B, Hkv, n_tab, bs)
    ids = bc._block_index(torch.nn.functional.pad(
        bt.long(), (0, npp - bt.shape[1])), nb)
    out = torch.empty(B, Hq, D)
    for b in range(B):
        c = int(ctx[b])
        n_walk = min(c, n_tab) if c > 0 else n_tab
        kk = k[ids[b]].reshape(n_tab, Hkv, D).transpose(0, 1)
        vv = v[ids[b]].reshape(n_tab, Hkv, D).transpose(0, 1)
        qg = q[b].reshape(Hkv, Hq // Hkv, D)
        parts = []
        for s in range(n_splits):
            c0 = s * chunk
            if c0 >= n_walk:
                parts.append(None)
                continue
            t = torch.arange(c0, min(c0 + chunk, n_walk))
            sc = torch.einsum("hgd,htd->hgt", qg, kk[:, t]) * scale
            sc = torch.where(t < c, sc, torch.tensor(pa.NEG_INF))
            m = torch.maximum(sc.amax(-1), torch.tensor(pa.NEG_INF))
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("hgt,htd->hgd", p,
                                                     vv[:, t])))
        live = [x for x in parts if x is not None]
        M = torch.stack([m for m, _, _ in live]).amax(0)
        w = [torch.exp(m - M) for m, _, _ in live]
        o = sum(wi[..., None] * acc for wi, (_, _, acc) in zip(w, live))
        l = sum(wi * li for wi, (_, li, _) in zip(w, live))
        out[b] = (o / l.clamp_min(1e-30)[..., None]).reshape(Hq, D)
    return out


@pytest.mark.parametrize("n_pages,ppcb,ctxs", [
    (64, 4, [256, 600, 333, 417, 512, 289, 598, 260]),   # the engine's
    (64, 4, [64, 65, 128, 129, 0, 1024, 1025, 1]),        # chunk edges
    (7, 4, [0, 113, 200, 5]),         # ctx 0, the padding page, past it
    (128, 2, [1, 2, 7, 16, 3, 9, 11, 15]),   # short rows, 32 splits
])
def test_split_kv_partition_and_merge_match_the_reference(n_pages, ppcb,
                                                          ctxs):
    """The split-KV decomposition the card's kernel computes, emulated in
    fp32 (the splits of ``split_plan`` at the script's 132-SM card), held
    to the reference's paged_attention in interpret mode: rows ending on
    and one token past a chunk edge, ctx 0 (the uniform mean of V over the
    padded table, from every split), ctx past the table, rows whose every
    split but the first is empty, and table ids outside [0, nb)."""
    B, Hq, Hkv, D, bs = len(ctxs), 12, 2, 64, 16
    q, kp, vp, bt, _ = _attention_inputs(n_pages, B, Hq, Hkv, D, bs,
                                         n_pages)
    nb = kp.shape[0]
    bt[1, 0], bt[2, -1], bt[3, 1 % n_pages] = -3, nb + 4, -nb - 2
    ctx = np.asarray(ctxs, np.int32)
    assert pa.split_plan(B, Hkv, pa._padded_pages(n_pages, ppcb) * bs,
                         bs)[0] > 1
    ref = jax_paged_attention(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(bt),
                              jnp.asarray(ctx), D ** -0.5,
                              pages_per_compute_block=ppcb)
    out = _split_kv_emulated(*(torch.from_numpy(a) for a in
                               (q, kp, vp, bt, ctx)), D ** -0.5, ppcb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
