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
