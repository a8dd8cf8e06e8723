"""repro_torch's per-block copy, grouped copy, flash attention and SSD scan
against the JAX package's Pallas kernels (CPU).

On the CPU each port wrapper takes its plain PyTorch version; the
reference's Pallas kernels run in interpret mode, as its own tests run
them, on the parameter grids of ``tests/test_kernels.py``.  Inputs are
made with numpy from a seed and handed to both.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import block_copy as jax_bc
from repro.kernels import ops as jax_ops
from repro.kernels.block_copy import block_copy as jax_block_copy
from repro.kernels.block_copy import block_copy_grouped as jax_grouped
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.gla_scan import gla_scan_scalar as jax_gla
from repro.kernels.ref import block_copy_ref as jax_block_copy_ref
from repro.kernels.ref import mha_ref as jax_mha_ref
from repro.models.gla import gla_scan_ref as jax_gla_scan_ref
from repro_torch.kernels import block_copy as bc
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gla_scan as gla
from repro_torch.kernels import ops, ref
from repro_torch.models.gla import gla_scan_ref
from torch_threads import one_torch_thread  # noqa: E402,F401

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Both sides compute in fp32 on the same (bf16-exact) inputs and differ
# only in the order of their sums.  Measured (this file's grids): flash
# fp32 outputs within 5e-7, SSD-scan fp32 y within 8.6e-6 (|y| up to 6.6)
# and S within 1.7e-6.  bf16 outputs round once to bf16 after those sums,
# so they may differ by one bf16 ulp: at most 2^-7 relative, with an
# absolute floor for values near 0.  Held per element as
# |out - ref| <= atol + rtol * |ref|.
FLASH_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": dict(atol=1e-5, rtol=2 ** -7)}
GLA_Y_TOL = {"float32": dict(atol=2e-5, rtol=1e-5),
             "bfloat16": dict(atol=2e-5, rtol=2 ** -7)}
GLA_S_TOL = dict(atol=1e-5, rtol=1e-5)     # S is fp32 in both dtypes


def _bits(a):
    """The raw bytes of a tensor or array, for byte-for-byte equality."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _pools(seed, n_src, n_dst, E, dtype):
    """Finite random source pool and a random destination pool (numpy
    fp32, exact in bf16), as (jax src, jax dst, torch src, torch dst)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((n_src, E)).astype(np.float32)
    dst = rng.standard_normal((n_dst, E)).astype(np.float32)
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    return (jnp.asarray(src, jd), jnp.asarray(dst, jd),
            torch.from_numpy(src).to(td), torch.from_numpy(dst).to(td))


# ---------------------------------------------------------------------------
# per-block copy (kernel 3)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_src,n_dst,n_copy,E", [
    (8, 8, 3, 128), (16, 4, 4, 256), (32, 32, 32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_copy_byte_equal_with_pallas(n_src, n_dst, n_copy, E, dtype):
    js, jdst, ts, tdst = _pools(n_src * 100 + E, n_src, n_dst, E, dtype)
    rng = np.random.RandomState(1)
    si = rng.choice(n_src, n_copy, replace=False).astype(np.int32)
    di = rng.choice(n_dst, n_copy, replace=False).astype(np.int32)
    want = jax_block_copy(js, jdst, jnp.asarray(si), jnp.asarray(di))
    assert np.array_equal(_bits(jax_block_copy_ref(js, jdst, si, di)),
                          _bits(want))
    plain = bc.block_copy_plain(ts, tdst.clone(), torch.from_numpy(si),
                                torch.from_numpy(di))
    launches = bc.block_copy.launches
    via_ops = ops.copy_blocks(ts, tdst.clone(), si, di)
    assert bc.block_copy.launches == launches          # CPU: plain version
    oracle = ref.block_copy_ref(ts, tdst, torch.from_numpy(si),
                                torch.from_numpy(di))
    for out in (plain, via_ops, oracle):
        assert np.array_equal(_bits(out), _bits(want))
    # the copy is in place on dst and returns it
    d = tdst.clone()
    assert bc.block_copy(ts, d, torch.from_numpy(si),
                         torch.from_numpy(di)) is d


@pytest.mark.parametrize("si,di", [
    ([9, -1, 0, 2], [0, 1, 2, 3]),        # source past the end, negative
    ([1, 2, 3], [-3, 7, -9]),             # destinations out of range
    ([0, 1], [-2 ** 31, 2 ** 31 - 1]),    # int32 extremes
])
def test_block_copy_clamps_indices_as_pallas(si, di):
    """Out-of-range indices: a negative index counts from the end, then
    the index is clamped into the pool (on a 4-block pool source 9 reads
    block 3), never outside it."""
    js, jdst, ts, tdst = _pools(5, 4, 4, 24, "float32")
    si, di = np.asarray(si, np.int32), np.asarray(di, np.int32)
    want = jax_block_copy(js, jdst, jnp.asarray(si), jnp.asarray(di))
    out = ops.copy_blocks(ts, tdst.clone(), si, di)
    assert np.array_equal(_bits(out), _bits(want))


@pytest.mark.parametrize("si,di", [
    ([0, 2], [1, 1]),
    ([3, 0, 1, 2], [2, 0, 2, 2]),
    ([0, 1, 2], [5, 3, 3]),               # clamped onto one block
])
def test_block_copy_repeated_destination_last_write_wins(si, di):
    """Several pairs naming one destination block: the reference's
    sequential grid leaves the last pair's bytes (dst [1, 1] from src
    [0, 2] gives block 1 the bytes of src block 2)."""
    js, jdst, ts, tdst = _pools(6, 4, 4, 16, "bfloat16")
    si, di = np.asarray(si, np.int32), np.asarray(di, np.int32)
    want = jax_block_copy(js, jdst, jnp.asarray(si), jnp.asarray(di))
    out = ops.copy_blocks(ts, tdst.clone(), si, di)
    assert np.array_equal(_bits(out), _bits(want))
    if list(di) == [1, 1]:
        assert torch.equal(out[1], ts[2])


@pytest.mark.parametrize("E,dtype", [(3, "float32"), (5, "bfloat16"),
                                     (7, "bfloat16"), (13, "float32")])
def test_copies_take_rows_that_are_not_16_byte_multiples(E, dtype):
    """Rows of 12, 10, 14 and 52 bytes through both copies."""
    js, jdst, ts, tdst = _pools(E, 8, 10, E, dtype)
    si = np.asarray([7, 0, 3], np.int32)
    di = np.asarray([9, 2, 5], np.int32)
    want = jax_block_copy(js, jdst, jnp.asarray(si), jnp.asarray(di))
    out = ops.copy_blocks(ts, tdst.clone(), si, di)
    assert np.array_equal(_bits(out), _bits(want))
    runs, starts = [(0, 3), (5, 2)], [6, 1]
    want = jax_ops.copy_block_runs(js, jdst, runs, starts)
    out = ops.copy_block_runs(ts, tdst.clone(), runs, starts)
    assert np.array_equal(_bits(out), _bits(want))


# ---------------------------------------------------------------------------
# grouped run copy (kernel 4)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("runs", [
    [(0, 4), (10, 2)],
    [(3, 1)],
    [(0, 8), (8, 8), (20, 4)],
])
def test_block_copy_grouped_byte_equal_with_pallas(runs):
    js, jdst, ts, tdst = _pools(7, 32, 40, 96, "float32")
    dst_starts, d = [], 1
    for _, n in runs:
        dst_starts.append(d)
        d += n + 1
    run_blocks = max(n for _, n in runs)
    args = ([r[0] for r in runs], dst_starts, [r[1] for r in runs])
    want = jax_grouped(js, jdst, *(jnp.asarray(a, jnp.int32) for a in args),
                       run_blocks=run_blocks)
    plain = bc.block_copy_grouped_plain(
        ts, tdst.clone(), *(torch.tensor(a, dtype=torch.int32)
                            for a in args), run_blocks)
    launches = bc.block_copy_grouped.launches
    via_ops = ops.copy_block_runs(ts, tdst.clone(), runs, dst_starts)
    assert bc.block_copy_grouped.launches == launches
    jax_via_ops = jax_ops.copy_block_runs(js, jdst, runs, dst_starts)
    for out in (plain, via_ops):
        assert np.array_equal(_bits(out), _bits(want))
        assert np.array_equal(_bits(out), _bits(jax_via_ops))


@pytest.mark.parametrize("src,dst,lens,run_blocks", [
    ([1], [2], [3], 3),                 # runs off the end: last step wins
    ([-5], [-1], [4], 4),               # negative starts
    ([0, 2, 6], [0, 1, 3], [2, 2, 0], 4),   # overlapping runs, a pad run
    ([2 ** 31 - 2], [0], [4], 4),       # int32 wrap-around of start + j
    ([0, 1], [1, 0], [3, 2], 2),        # run_blocks cuts the first run
])
def test_block_copy_grouped_edges_as_pallas(src, dst, lens, run_blocks):
    """Clamped and negative indices, destinations named twice (the
    sequential grid's last step wins), zero-length runs, and steps past
    ``run_blocks``, on an 8-block pool."""
    js, jdst, ts, tdst = _pools(8, 8, 8, 6, "bfloat16")
    args = (src, dst, lens)
    want = jax_grouped(js, jdst, *(jnp.asarray(a, jnp.int32) for a in args),
                       run_blocks=run_blocks)
    out = bc.block_copy_grouped(ts, tdst.clone(),
                                *(torch.tensor(a, dtype=torch.int32)
                                  for a in args), run_blocks)
    assert np.array_equal(_bits(out), _bits(want))


@pytest.mark.parametrize("src,dst,lens,run_blocks", [
    ([6], [0], [4], 4),                 # past the end of the source pool
    ([0], [6], [4], 4),                 # past the end of the destination
    ([-3], [-2], [3], 3),               # negative starts
    ([5, -1, 0], [6, 1, 3], [4, 2, 0], 4),  # all three, and a pad run
    ([7, 2], [7, 0], [3, 5], 2),        # run_blocks cuts both runs
])
@pytest.mark.parametrize("direction", ["gather", "scatter"])
def test_run_copy_past_the_end_byte_equal_with_pallas(src, dst, lens,
                                                     run_blocks, direction):
    """The 56-plane run copy's plain version follows the reference's grid
    where a run leaves a pool: steps clamp onto the last block (the last
    step naming it wins), a negative start counts from the end, and steps
    j >= run_blocks copy nothing; on C = 4 planes of 8-block pools, both
    directions, byte for byte with interpret mode."""
    rng = np.random.default_rng(len(src) * 10 + run_blocks)
    C, nb, bs, H, D = 4, 8, 2, 1, 3
    a = rng.standard_normal((C, nb, bs, H, D)).astype(np.float32)
    b = rng.standard_normal((C, nb, bs, H, D)).astype(np.float32)
    idx = [np.asarray(x, np.int32) for x in (src, dst, lens)]
    jax_fn = {"gather": jax_bc.block_gather_runs,
              "scatter": jax_bc.block_scatter_runs}[direction]
    port_fn = {"gather": bc.block_gather_runs,
               "scatter": bc.block_scatter_runs}[direction]
    want = jax_fn(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                  *(jnp.asarray(x) for x in idx), run_blocks=run_blocks)
    ta, tb = (torch.from_numpy(x).bfloat16() for x in (a, b))
    ti = [torch.from_numpy(x) for x in idx]
    launches = port_fn.launches
    out = port_fn(ta, tb.clone(), *ti, run_blocks)
    assert port_fn.launches == launches              # CPU: plain version
    plain = bc.copy_runs_plain(ta, tb.clone(), *ti, run_blocks)
    for got in (out, plain):
        assert np.array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# flash attention (kernel 5)
# ---------------------------------------------------------------------------


def _qkv(seed, B, H, T, S, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, T, D)).astype(np.float32),
            rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, H, S, D)).astype(np.float32))


def _flash_both(q, k, v, dtype, **kw):
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    want = jax_flash(*(jnp.asarray(x, jd) for x in (q, k, v)), **kw)
    launches = fa.flash_attention.launches
    out = ops.flash_attention(*(torch.from_numpy(x).to(td)
                                for x in (q, k, v)), **kw)
    assert fa.flash_attention.launches == launches
    assert out.dtype == td and out.shape == q.shape
    return out, np.asarray(want, np.float32)


@pytest.mark.parametrize("B,H,T,D,bq,bk", [
    (1, 2, 128, 64, 64, 64),
    (2, 4, 256, 64, 128, 64),
    (1, 1, 512, 128, 128, 128),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(B, H, T, D, bq, bk, causal, dtype):
    q, k, v = _qkv(T + D, B, H, T, T, D)
    out, want = _flash_both(q, k, v, dtype, causal=causal, block_q=bq,
                            block_k=bk)
    np.testing.assert_allclose(out.float().numpy(), want,
                               **FLASH_TOL[dtype])
    # T == S: the oracle's bottom-right mask is the kernel's top-left one
    oracle = ref.mha_ref(*(torch.from_numpy(x).to(TORCH_DTYPES[dtype])
                           .transpose(1, 2) for x in (q, k, v)),
                         causal=causal).transpose(1, 2)
    np.testing.assert_allclose(out.float().numpy(), oracle.float().numpy(),
                               **FLASH_TOL[dtype])
    plain = fa.flash_attention_plain(
        *(torch.from_numpy(x).to(TORCH_DTYPES[dtype]) for x in (q, k, v)),
        causal=causal, block_q=bq, block_k=bk)
    assert torch.equal(plain, out)


@pytest.mark.parametrize("T,S", [(64, 192), (256, 128)])
def test_flash_attention_causal_mask_is_top_left_when_t_ne_s(T, S):
    """T != S: the port follows the Pallas kernel (key col visible to row
    when col <= row, both from index 0), not ``mha_ref``'s bottom-right
    ``tril(k=S-T)``, which gives other outputs here."""
    q, k, v = _qkv(T * 7 + S, 1, 2, T, S, 64)
    out, want = _flash_both(q, k, v, "float32", causal=True, block_q=64,
                            block_k=64)
    np.testing.assert_allclose(out.numpy(), want, **FLASH_TOL["float32"])
    bottom_right = np.asarray(jax_mha_ref(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        causal=True)).transpose(0, 2, 1, 3)
    port_oracle = ref.mha_ref(*(torch.from_numpy(x).transpose(1, 2)
                                for x in (q, k, v))).transpose(1, 2)
    np.testing.assert_allclose(port_oracle.numpy(), bottom_right,
                               atol=1e-5, rtol=1e-5)
    assert np.abs(out.numpy() - bottom_right).max() > 0.1


def test_flash_attention_keeps_the_reference_block_contract():
    q = torch.zeros((1, 1, 96, 64))
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(q, q, q, block_q=64, block_k=64)
    # blocks are capped at T and S, as the reference caps them
    out = ops.flash_attention(q, q, q, block_q=128, block_k=256)
    assert out.shape == q.shape


# ---------------------------------------------------------------------------
# scalar-decay chunked GLA scan (kernel 6)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,T,N,P,chunk", [
    (1, 1, 64, 8, 8, 16),
    (2, 3, 128, 16, 32, 32),
    (1, 2, 96, 32, 16, 32),      # T not a chunk multiple of 64
    (2, 1, 64, 64, 64, 64),      # one chunk == T
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gla_scan_scalar_matches_pallas_and_sequential_scan(B, H, T, N, P,
                                                           chunk, dtype):
    rng = np.random.default_rng(B * 1000 + T + N)
    q = (rng.standard_normal((B, H, T, N)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, H, T, N)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, H, T, P)) * 0.5).astype(np.float32)
    logw = -np.exp(rng.standard_normal((B, H, T)) * 0.5 - 1.0)
    logw = logw.astype(np.float32)
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    want_y, want_s = jax_gla(*(jnp.asarray(x, jd) for x in (q, k, v)),
                             jnp.asarray(logw), chunk=chunk)
    want_y = np.asarray(want_y, np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    launches = gla.gla_scan_scalar.launches
    y, s = ops.gla_scan_scalar(tq, tk, tv, torch.from_numpy(logw),
                               chunk=chunk)
    assert gla.gla_scan_scalar.launches == launches
    assert y.dtype == td and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), want_y, **GLA_Y_TOL[dtype])
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **GLA_S_TOL)
    # the sequential oracle, and its port against the reference's
    lw_n = np.broadcast_to(logw[..., None], (B, H, T, N))
    seq_y, seq_s = gla_scan_ref(tq, tk, tv, torch.from_numpy(lw_n.copy()))
    np.testing.assert_allclose(y.float().numpy(), seq_y.float().numpy(),
                               **GLA_Y_TOL[dtype])
    np.testing.assert_allclose(s.numpy(), seq_s.numpy(), **GLA_S_TOL)
    jseq_y, jseq_s = jax_gla_scan_ref(*(jnp.asarray(x, jd)
                                        for x in (q, k, v)),
                                      jnp.asarray(lw_n), mode="mamba")
    np.testing.assert_allclose(seq_y.float().numpy(),
                               np.asarray(jseq_y, np.float32),
                               **GLA_Y_TOL[dtype])
    np.testing.assert_allclose(seq_s.numpy(), np.asarray(jseq_s),
                               **GLA_S_TOL)


def test_gla_scan_ref_rwkv_mode_matches_reference():
    """The sequential oracle's other read (before the update, with the u
    bonus) and an initial state, against the reference's."""
    rng = np.random.default_rng(3)
    B, H, T, N, P = 1, 2, 12, 8, 4
    q, k = (rng.standard_normal((B, H, T, N)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, T, P)).astype(np.float32)
    logw = -np.exp(rng.standard_normal((B, H, T, N))).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    want_y, want_s = jax_gla_scan_ref(
        *(jnp.asarray(x) for x in (q, k, v, logw)), u=jnp.asarray(u),
        mode="rwkv", initial_state=jnp.asarray(s0))
    y, s = gla_scan_ref(*(torch.from_numpy(x) for x in (q, k, v, logw)),
                            u=torch.from_numpy(u), mode="rwkv",
                            initial_state=torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=1e-5,
                               rtol=1e-5)


def _split_sum(x, n_terms):
    """x fed to the tensor cores as ``n_terms`` bf16 terms (hi = bf16(x),
    then bf16 of each residue), summed smallest first as the kernel's MMAs
    accumulate them; ``None``: x kept in fp32."""
    if n_terms is None:
        return x
    terms, rest = [], x
    for _ in range(n_terms):
        terms.append(rest.bfloat16().float())
        rest = rest - terms[-1]
    return sum(terms[::-1])


def _gla_emulated(q, k, v, logw, chunk, terms):
    """The bf16 CUDA kernel's decomposition of the scan, in fp32 on the
    CPU: one 16-wide slice of P at a time, y = exp(L) (q S) + A v and S <-
    exp(L_C) S + k^T V_w with V_w = v * exp(L_C - L), where A, S and V_w
    enter their products as ``terms["A"]``, ``terms["S"]`` and
    ``terms["W"]`` bf16 terms; q, k, v are bf16-exact."""
    B, H, T, N = q.shape
    P = v.shape[-1]
    tril = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    ys, states = [], []
    for p0 in range(0, P, 16):
        vs = v[..., p0:p0 + 16].float()
        S = torch.zeros(B, H, N, vs.shape[-1])
        parts = []
        for c0 in range(0, T, chunk):
            qc, kc = (x[:, :, c0:c0 + chunk].float() for x in (q, k))
            vc = vs[:, :, c0:c0 + chunk]
            L = torch.cumsum(logw[:, :, c0:c0 + chunk].float(), -1)
            inter = qc @ _split_sum(S, terms["S"])
            A = (qc @ kc.transpose(-1, -2)) * torch.exp(
                torch.clamp(L[..., :, None] - L[..., None, :], max=0.0))
            A = torch.where(tril, A, 0.0)
            parts.append((torch.exp(L)[..., None] * inter
                          + _split_sum(A, terms["A"]) @ vc).to(q.dtype))
            L_C = L[..., -1:]
            vw = vc * torch.exp(L_C - L)[..., None]
            S = torch.exp(L_C)[..., None] * S \
                + kc.transpose(-1, -2) @ _split_sum(vw, terms["W"])
        ys.append(torch.cat(parts, 2))
        states.append(S)
    return torch.cat(ys, -1), torch.cat(states, -1)


def test_gla_tolerance_fails_rounded_operands_and_passes_split_operands():
    """chip_smoke's scan gate (y: GLA_Y_ATOL + 2^-7 |ref|, S: GLA_S_ATOL +
    GLA_S_RTOL |ref|) at zamba2-7b's head shape (N = P = chunk = 64, 2
    heads, T 512, chip_smoke.gla_case's inputs): the kernel's
    decomposition with A, S and V_w each in three bf16 terms passes it, as
    fp32 operands do; any one of them rounded once to bf16 fails it.  Two
    terms of A also pass, but flip the bf16 rounding of ~0.2 % of y
    against fp32 operands; three flip none."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    q, k, v, logw = chip_smoke.gla_case(torch.device("cpu"), 3, H=2, T=512)
    want_y, want_s = gla.gla_scan_scalar_plain(q, k, v, logw)
    kernel = dict(A=3, S=3, W=3)
    y, s = _gla_emulated(q, k, v, logw, 64, kernel)
    chip_smoke.gla_errors(y, s, want_y, want_s)
    fp32_y, fp32_s = _gla_emulated(q, k, v, logw, 64,
                                   dict(A=None, S=None, W=None))
    chip_smoke.gla_errors(fp32_y, fp32_s, want_y, want_s)
    for rounded in ("A", "S", "W"):
        with pytest.raises(AssertionError, match="max abs error"):
            chip_smoke.gla_errors(*_gla_emulated(
                q, k, v, logw, 64, {**kernel, rounded: 1}), want_y, want_s)
    two_a, _ = _gla_emulated(q, k, v, logw, 64, {**kernel, "A": 2})
    assert float((two_a != fp32_y).float().mean()) > 1e-3
    assert float((y != fp32_y).float().mean()) < 1e-4


def test_gla_launch_plan_tiles_p_and_fits_shared_memory():
    """For every shape of the scan's card tests and zamba2-7b's: the CTAs
    of a (batch, head) cover P with whole slices of 16, 32 or 64 columns
    (the last one ragged at most, none wider than P needs), bf16 takes the
    tensor cores where N is at most 128 and chunk at most 64, and every
    CTA's shared memory fits the card; at zamba2-7b's shape one CTA a head
    (112 CTAs, one wave on 132 SMs).  The plan's constants are the CUDA
    source's."""
    import re
    import sys

    from repro_torch.kernels import build
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_gpu_kernels import GLA_SHAPES

    consts = dict((n, int(x)) for n, x in re.findall(
        r"constexpr int (\w+) = (\d+);",
        (build.CSRC / build.SOURCES["gla_scan"]).read_text()))
    assert (consts["kMaxN"], consts["kMaxC"], consts["kMaxSmem"],
            consts["kFmaPt"]) == (gla.MMA_MAX_N, gla.MMA_MAX_CHUNK,
                                  gla.MAX_SMEM_BYTES, gla.FMA_P_SPLIT)
    assert (consts["kStages"], consts["kWarps"], consts["kTermsA"],
            consts["kTermsS"], consts["kTermsW"]) == \
        (gla._STAGES, gla._WARPS, gla._TERMS_A, gla._TERMS_S, gla._TERMS_W)
    for B, H, T, N, P, chunk in GLA_SHAPES + [(1, 112, 4096, 64, 64, 64)]:
        for bf16 in (False, True):
            plan = gla.launch_plan(N, P, chunk, bf16)
            assert plan.pt in (16, 32, 64)
            assert (plan.p_splits - 1) * plan.pt < P \
                <= plan.p_splits * plan.pt
            assert plan.pt == 16 or plan.pt // 2 < P
            assert plan.route == ("mma" if bf16 and N <= 128 and chunk <= 64
                                  else "fma")
            assert 0 < plan.smem <= gla.MAX_SMEM_BYTES
    assert gla.launch_plan(64, 64, 64, True) == gla.Plan("mma", 64, 1,
                                                         211_480)
    assert gla.launch_plan(128, 64, 64, True).pt == 32


def test_gla_scan_probe_edits_apply_to_the_kernel_source():
    """scripts/gla_scan_probe.py builds its variants by text edits of
    csrc/gla_scan.cu: every edited line is still in the source."""
    import importlib.util

    from repro_torch.kernels import build
    spec = importlib.util.spec_from_file_location(
        "gla_scan_probe", os.path.join(os.path.dirname(__file__), "..",
                                       "scripts", "gla_scan_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = (build.CSRC / build.SOURCES["gla_scan"]).read_text()
    for name, edits in probe.VARIANTS.items():
        for old, _ in edits:
            assert old in src, (name, old)


def test_gla_scan_scalar_refuses_a_ragged_chunk():
    q = torch.zeros((1, 1, 96, 8))
    with pytest.raises(ValueError, match="chunk"):
        ops.gla_scan_scalar(q, q, q, torch.zeros((1, 1, 96)), chunk=64)


def test_ctypes_signatures_match_the_c_entry_points():
    """Every ``extern "C"`` entry point of ``csrc/*.cu`` is bound with one
    ctypes type per parameter, in order (a pointer passed as a 32-bit int
    would be cut)."""
    import ctypes
    import re

    from repro_torch.kernels import build
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "longlong": ctypes.c_longlong, "float": ctypes.c_float}
    for name, source in build.SOURCES.items():
        text = (build.CSRC / source).read_text()
        found = {}
        for ret, fn, params in re.findall(
                r'extern "C" (\w+) (\w+)\(([^)]*)\)', text):
            kinds = []
            for p in params.split(","):
                words = p.replace("const", "").replace("*", " * ").split()
                base = "".join(w for w in words[:-1] if w != "*")
                kinds.append("void*" if "*" in words else base)
            found[fn] = ([ctype[k] for k in kinds], ctype[ret])
        assert found == build.SIGNATURES[name], source
