"""Card tests: each hand-written CUDA kernel of repro_torch against its
plain PyTorch version on the same inputs.

Marked ``gpu``; each test skips when ``torch.cuda.is_available()`` is
false (decided in the ``cuda`` fixture, never at import, so every xdist
worker collects the same tests).  Run them on a machine with an H100 and
the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import block_copy as bc
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa

pytestmark = pytest.mark.gpu

# bf16 output of a softmax-weighted mean of N(0, 1) values: both sides
# round once to bf16 after fp32 sums taken in different orders, so they
# may differ by one bf16 ulp (at most 2^-7 relative) per element; the
# absolute floor covers outputs near 0.  Long rows average to ~0.05, so a
# dropped or doubled 64-token tile (a change of several percent) fails.
ATOL, RTOL = 1e-3, 2 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _attention_case(rng, B, Hq, Hkv, D, bs, n_pages, ctxs, trash_rows=()):
    nb = B * n_pages + 2
    trash = nb - 1
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    bt = rng.permutation(nb - 1)[:B * n_pages].reshape(B, n_pages)
    bt = bt.astype(np.int32)
    for r in trash_rows:
        bt[r] = trash
    return q, k, v, bt, np.asarray(ctxs, np.int32)


def _to(dev, *arrays, dtype=torch.bfloat16):
    return [torch.from_numpy(a).to(dev, dtype) for a in arrays]


@pytest.mark.parametrize("B,Hq,Hkv,D,bs,n_pages,ppcb", [
    (8, 12, 2, 128, 16, 128, 4),     # qwen2-1.5b, ctx up to 2048
    (32, 12, 2, 128, 16, 128, 4),
    (5, 12, 2, 128, 16, 7, 4),       # ragged page tile
    (3, 8, 2, 128, 16, 4, 1),        # tests/test_kernels.py's table shapes
    (1, 8, 1, 128, 16, 8, 2),
])
def test_paged_attention_kernel_matches_plain(cuda, B, Hq, Hkv, D, bs,
                                              n_pages, ppcb):
    rng = np.random.default_rng(B * 1000 + n_pages)
    hi = n_pages * bs
    ctxs = np.linspace(1, hi, B).astype(np.int32)
    ctxs[0] = 0                                   # uniform mean of V
    trash_rows = (B - 1,) if B > 2 else ()
    if trash_rows:
        ctxs[B - 1] = 1                           # a freed decode row
    q, k, v, bt, ctx = _attention_case(rng, B, Hq, Hkv, D, bs, n_pages,
                                       ctxs, trash_rows)
    qd, kd, vd = _to(cuda, q, k, v)
    btd, ctxd = _to(cuda, bt, ctx, dtype=torch.int32)
    before = pa.paged_attention.launches
    out = pa.paged_attention(qd, kd, vd, btd, ctxd, D ** -0.5, ppcb)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    ref = pa.paged_attention_plain(qd, kd, vd, btd, ctxd, D ** -0.5, ppcb)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=RTOL)


def test_paged_attention_kernel_refuses_fp32(cuda):
    q = torch.zeros((1, 4, 128), device=cuda)
    kv = torch.zeros((2, 16, 2, 128), device=cuda)
    bt = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    ctx = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pa.paged_attention(q, kv, kv, bt, ctx, 0.125)
    with pytest.raises(ValueError):                 # head_dim 64: not served
        pa.paged_attention(q[..., :64].bfloat16().contiguous(),
                           kv[..., :64].bfloat16().contiguous(),
                           kv[..., :64].bfloat16().contiguous(), bt, ctx,
                           0.125)


@pytest.mark.parametrize("runs", [
    [(3, 5), (20, 1), (9, 7)],        # 3 runs -> 1 zero-length pad run
    [(0, 16)],
    [(40, 2), (1, 1), (30, 4), (12, 3), (50, 1)],
])
def test_swap_runs_kernel_byte_equal(cuda, runs):
    """gather (pool -> zeroed slab) and scatter (slab -> pool) at
    qwen2-1.5b's block layout (C = 56 planes, E = 4096 bf16): byte-equal
    with the plain copy, untouched pool blocks keep their bytes."""
    rng = np.random.default_rng(len(runs))
    L, nb, bs, H, D = 28, 64, 16, 2, 128
    bits = rng.integers(0, 2 ** 16, (L, 2, nb, bs, H, D), dtype=np.uint16)
    pool = torch.from_numpy(bits.view(np.int16)).to(cuda).view(torch.bfloat16)
    g0 = bc.block_gather_runs.launches
    slab, total = ops.gather_swap_runs(pool, runs)
    assert bc.block_gather_runs.launches == g0 + 1
    cpu_slab, _ = ops.gather_swap_runs(pool.cpu(), runs)
    assert torch.equal(slab.cpu().view(torch.int16),
                       cpu_slab.view(torch.int16))
    # scatter the slab into a second pool at other, disjoint runs
    dst_runs, off = [], 5
    for _, n in runs:
        dst_runs.append((off, n))
        off += n + 2
    bits2 = rng.integers(0, 2 ** 16, bits.shape, dtype=np.uint16)
    pool2 = torch.from_numpy(bits2.view(np.int16)).to(cuda).view(torch.bfloat16)
    ref2 = pool2.cpu().clone()
    s0 = bc.block_scatter_runs.launches
    ops.scatter_swap_runs(pool2, slab, dst_runs)
    torch.cuda.synchronize()
    assert bc.block_scatter_runs.launches == s0 + 1
    ops.scatter_swap_runs(ref2, cpu_slab, dst_runs)
    assert torch.equal(pool2.cpu().view(torch.int16), ref2.view(torch.int16))
    assert total == sum(n for _, n in runs)
