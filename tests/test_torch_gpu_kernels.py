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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gla_scan as gla
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


def _plan(B, Hkv, n_pages, bs, ppcb):
    """(n_splits, chunk, padded table tokens) of the kernel's launch."""
    n_tab = pa._padded_pages(n_pages, ppcb) * bs
    return (*pa.split_plan(B, Hkv, n_tab, bs, pa._sm_count(0)), n_tab)


def _edges(B, ch, tab):
    """Rows ending on a chunk edge and one token past it, up to the
    table's end."""
    ctxs = []
    for k in range(1, tab // ch + 1):
        ctxs += [k * ch, k * ch + 1]
    return (ctxs * B)[:B - 1] + [tab - 1]


# name: (B, group, Hkv, bs, n_pages, ppcb, contexts from (rng, B, chunk,
# padded table), whether the plan must split)
SPLIT_CASES = {
    "engine_B8_pages64": (8, 6, 2, 16, 64, 4,
                          lambda rng, B, ch, tab: rng.integers(256, 601, B),
                          True),
    "chunk_edges_B8": (8, 6, 2, 16, 128, 4,
                       lambda rng, B, ch, tab: _edges(B, ch, tab), True),
    "chunk_edges_B32": (32, 6, 2, 16, 128, 4,
                        lambda rng, B, ch, tab: _edges(B, ch, tab), True),
    "ctx0_many_splits": (4, 6, 2, 16, 64, 4,
                         lambda rng, B, ch, tab: [0, 0, 300, 0], True),
    "ctx_past_table": (4, 6, 2, 16, 7, 4,
                       lambda rng, B, ch, tab: [200, 10 ** 6, tab - 15, 0],
                       True),
    "only_first_split": (8, 6, 2, 16, 128, 4,
                         lambda rng, B, ch, tab: [1, ch, ch - 1, 17, 2, ch,
                                                  30, 63], True),
    "short_rows_many_splits": (16, 6, 2, 16, 128, 4,
                               lambda rng, B, ch, tab: range(1, B + 1), True),
    "group1": (6, 1, 2, 16, 32, 4,
               lambda rng, B, ch, tab: [0, 1, 77, 300, 512, 65], True),
    "group4": (6, 4, 2, 16, 32, 4,
               lambda rng, B, ch, tab: [0, 1, 77, 300, 512, 65], True),
    "group6": (6, 6, 2, 16, 32, 4,
               lambda rng, B, ch, tab: [0, 1, 77, 300, 512, 65], True),
    "group8": (6, 8, 2, 16, 32, 4,
               lambda rng, B, ch, tab: [0, 1, 77, 300, 512, 65], True),
    "bs32": (6, 6, 2, 32, 32, 4,
             lambda rng, B, ch, tab: [0, 1, 77, 300, 1024, 1023], True),
    "ppcb1": (5, 6, 2, 16, 7, 1,
              lambda rng, B, ch, tab: [0, 1, 64, 112, 113], True),
    "ppcb2": (5, 6, 2, 16, 7, 2,
              lambda rng, B, ch, tab: [0, 1, 64, 112, 113], True),
    "ppcb4": (5, 6, 2, 16, 7, 4,
              lambda rng, B, ch, tab: [0, 1, 64, 112, 113], True),
    "one_split_fills_the_card": (200, 6, 2, 16, 8, 4,
                                 lambda rng, B, ch, tab:
                                 rng.integers(0, 129, B), False),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_paged_attention_split_kv_matches_plain(cuda, name):
    """The split-KV kernel at the partitions its edges meet: the engine's
    bucket (B 8, 64 pages, contexts 256-600), rows ending on a chunk edge
    and one token past it, ctx 0 (the uniform mean of V from every split),
    ctx past the table (the padding page 0 read), rows whose every split
    but the first is empty, rows of 1-16 tokens over 32 splits, groups 1,
    4, 6 and 8, pages of 16 and 32, page tiles 1, 2 and 4, and one split
    where the rows fill the card (the kernel writes bf16 itself)."""
    B, G, Hkv, bs, n_pages, ppcb, ctx_of, splits = SPLIT_CASES[name]
    n_splits, chunk, tab = _plan(B, Hkv, n_pages, bs, ppcb)
    assert (n_splits > 1) == splits
    rng = np.random.default_rng(len(name))
    ctxs = np.asarray(list(ctx_of(rng, B, chunk, tab)), np.int32)
    q, k, v, bt, ctx = _attention_case(rng, B, G * Hkv, Hkv, 128, bs,
                                       n_pages, ctxs)
    qd, kd, vd = _to(cuda, q, k, v)
    btd, ctxd = _to(cuda, bt, ctx, dtype=torch.int32)
    before = pa.paged_attention.launches
    out = pa.paged_attention(qd, kd, vd, btd, ctxd, 128 ** -0.5, ppcb)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    ref = pa.paged_attention_plain(qd, kd, vd, btd, ctxd, 128 ** -0.5, ppcb)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("B,n_pages", [(4, 3), (8, 64)])
def test_paged_attention_kernel_follows_the_tpu_index_rule(cuda, B, n_pages):
    """Table ids outside [0, nb) on a 6-block pool: -3 reads block 3, 9
    block 5, -9 block 0, as the reference's index map and the plain
    version read them."""
    rng = np.random.default_rng(B)
    nb, bs, Hq, Hkv, D = 6, 16, 12, 2, 128
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    bt = rng.choice(np.array([-3, -9, 9, 2, -1, 0], np.int32), (B, n_pages))
    ctx = rng.integers(0, n_pages * bs + 20, B).astype(np.int32)
    ctx[0] = 0
    qd, kd, vd = _to(cuda, q, k, v)
    btd, ctxd = _to(cuda, bt, ctx, dtype=torch.int32)
    out = pa.paged_attention(qd, kd, vd, btd, ctxd, D ** -0.5, 4)
    ref = pa.paged_attention_plain(qd, kd, vd, btd, ctxd, D ** -0.5, 4)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=RTOL)


def test_paged_attention_kernel_is_deterministic(cuda):
    """Two launches on the same inputs are bit-equal: the splits merge in
    a fixed order, with no float atomics."""
    rng = np.random.default_rng(32)
    ctxs = np.linspace(0, 2048, 32).astype(np.int32)
    q, k, v, bt, ctx = _attention_case(rng, 32, 12, 2, 128, 16, 128, ctxs)
    args = (*_to(cuda, q, k, v), *_to(cuda, bt, ctx, dtype=torch.int32))
    assert _plan(32, 2, 128, 16, 4)[0] > 1
    a = pa.paged_attention(*args, 128 ** -0.5, 4)
    b = pa.paged_attention(*args, 128 ** -0.5, 4)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def _sass_kernels(name):
    """{kernel name: whether its SASS holds HMMA} of a built library."""
    import re
    import shutil
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import build
    lib = build.build([name])[name].path
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool if tool.exists() else
                               shutil.which("cuobjdump")), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return {n: "HMMA" in body for n, body in
            re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass,
                       flags=re.S)}


def test_paged_attention_kernel_runs_on_the_tensor_cores(cuda):
    """The built paged-attention library, disassembled: the split kernel
    holds HMMA (tensor-core) instructions; the combine kernel is there."""
    kernels = _sass_kernels("paged_attention")
    split = [n for n in kernels if "paged_attention_split_kernel" in n]
    combine = [n for n in kernels if "paged_attention_combine_kernel" in n]
    assert len(split) == 1 and len(combine) == 1, sorted(kernels)
    assert kernels[split[0]]


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


@pytest.mark.parametrize("src,dst,lens,run_blocks", [
    ([60], [0], [8], 8),                # past the end of the source pool
    ([0], [60], [8], 8),                # past the end of the destination
    ([-3], [-2], [3], 4),               # negative starts
    ([61, -1, 0, 5], [62, 1, 30, 40], [6, 2, 0, 3], 8),   # all, a pad run
    ([7, 2], [63, 0], [3, 5], 2),       # run_blocks cuts both runs
])
@pytest.mark.parametrize("direction", ["gather", "scatter"])
def test_swap_runs_kernel_past_the_end_matches_plain(cuda, src, dst, lens,
                                                     run_blocks, direction):
    """Runs that leave a 64-block pool, over qwen2-1.5b's 56 planes of
    4096 bf16: the kernel clamps each step onto the last block and keeps
    the last step naming a block (its last-write pass), as the plain
    version and the reference's sequential grid do.  Byte for byte."""
    rng = np.random.default_rng(len(src) * 10 + run_blocks)
    shape = (56, 64, 16, 2, 128)
    a, b = (torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, shape,
                                          dtype=np.int16))
            .to(cuda).view(torch.bfloat16) for _ in range(2))
    idx = [torch.tensor(x, dtype=torch.int32, device=cuda)
           for x in (src, dst, lens)]
    fn = {"gather": bc.block_gather_runs,
          "scatter": bc.block_scatter_runs}[direction]
    want = bc.copy_runs_plain(a, b.clone(), *idx, run_blocks)
    before = fn.launches
    out = fn(a, b, *idx, run_blocks)
    torch.cuda.synchronize()
    assert out is b and fn.launches == before + 1
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))


# ---------------------------------------------------------------------------
# per-block copy, grouped copy, flash attention, SSD scan
# ---------------------------------------------------------------------------


def _bytes_equal(a, b):
    return torch.equal(a.contiguous().view(torch.uint8).cpu(),
                       b.contiguous().view(torch.uint8).cpu())


def _pool_pair(cuda, rng, n_src, n_dst, E, dtype):
    src = torch.from_numpy(rng.standard_normal((n_src, E)).astype(np.float32))
    dst = torch.from_numpy(rng.standard_normal((n_dst, E)).astype(np.float32))
    return src.to(cuda, dtype), dst.to(cuda, dtype)


@pytest.mark.parametrize("n_src,n_dst,si,di,E", [
    (8, 8, [4, 0, 7], [1, 6, 2], 128),          # tests/test_kernels.py's
    (16, 4, [3, 9, 15, 0], [2, 0, 3, 1], 256),  # grid shapes
    (32, 32, list(range(31, -1, -1)), list(range(32)), 64),
    (4, 4, [9, -1, 0, 2], [0, 1, 2, 3], 24),    # clamped and negative
    (4, 4, [0, 2], [1, 1], 16),                 # repeated: last pair wins
    (4, 4, [0, 1, 2, 3], [2, 2, 7, 2], 16),     # repeated through a clamp
    (8, 10, [7, 0, 3], [9, 2, 5], 5),           # 10- / 20-byte rows
    (8, 10, [7, 0, 3], [9, 2, 5], 13),          # 26- / 52-byte rows
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_copy_kernel_byte_equal(cuda, n_src, n_dst, si, di, E, dtype):
    rng = np.random.default_rng(n_src * 31 + E)
    src, dst = _pool_pair(cuda, rng, n_src, n_dst, E, dtype)
    want = bc.block_copy_plain(src, dst.clone(), torch.tensor(si),
                               torch.tensor(di))
    before = bc.block_copy.launches
    out = ops.copy_blocks(src, dst, si, di)
    torch.cuda.synchronize()
    assert out is dst and bc.block_copy.launches == before + 1
    assert _bytes_equal(out, want)


@pytest.mark.parametrize("src_s,dst_s,lens,run_blocks,E", [
    ([0, 10], [1, 6], [4, 2], 4, 96),           # tests/test_kernels.py's
    ([3], [1], [1], 1, 96),                     # grid runs
    ([0, 8, 20], [1, 10, 19], [8, 8, 4], 8, 96),
    ([1], [2], [3], 3, 6),                      # off the end: last wins
    ([-5], [-1], [4], 4, 6),                    # negative starts
    ([0, 2, 6], [0, 1, 3], [2, 2, 0], 4, 6),    # overlap, pad run
    ([0, 1], [1, 0], [3, 2], 2, 6),             # run_blocks cuts a run
    ([0, 5], [6, 1], [3, 2], 3, 7),             # 14- / 28-byte rows
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_copy_grouped_kernel_byte_equal(cuda, src_s, dst_s, lens,
                                              run_blocks, E, dtype):
    rng = np.random.default_rng(run_blocks * 17 + E)
    nb = 40 if E == 96 else 8
    src, dst = _pool_pair(cuda, rng, nb, nb, E, dtype)
    idx = [torch.tensor(a, dtype=torch.int32, device=cuda)
           for a in (src_s, dst_s, lens)]
    want = bc.block_copy_grouped_plain(src, dst.clone(), *idx, run_blocks)
    before = bc.block_copy_grouped.launches
    out = bc.block_copy_grouped(src, dst, *idx, run_blocks)
    torch.cuda.synchronize()
    assert out is dst and bc.block_copy_grouped.launches == before + 1
    assert _bytes_equal(out, want)


def test_copies_refuse_aliased_pools(cuda):
    pool = torch.zeros((8, 64), device=cuda)
    idx = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="share memory"):
        bc.block_copy(pool, pool, idx, idx)
    with pytest.raises(ValueError, match="share memory"):
        bc.block_copy_grouped(pool, pool[4:], idx[:1], idx[:1], idx[1:], 1)


# bf16 outputs of fp32 sums taken in other orders: one bf16 ulp (2^-7
# relative) per element; fp32 outputs: the sums' rounding only
FLASH_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7)}


@pytest.mark.parametrize("B,H,T,S,D", [
    (1, 2, 128, 128, 64),         # tests/test_kernels.py's shapes
    (2, 4, 256, 256, 64),
    (1, 1, 512, 512, 128),
    (1, 12, 2048, 2048, 128),     # qwen2-1.5b prefill
    (2, 3, 64, 192, 128),         # T != S: the top-left causal mask
    (1, 2, 320, 128, 64),
    (1, 2, 96, 96, 128),          # a ragged last q and k tile
    (8, 12, 512, 512, 128),       # qwen2-1.5b prefill, B 8
    (2, 3, 96, 352, 64),          # ragged last q and k tiles, S > T
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, H, T, S, D, causal,
                                              dtype):
    g = torch.Generator(device=cuda).manual_seed(B * 100 + T + S)
    q = torch.randn((B, H, T, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, H, S, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, H, S, D), generator=g, device=cuda).to(dtype)
    blk = 32 if T == 96 else 64
    before = fa.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, block_q=blk,
                              block_k=blk)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal, block_q=blk,
                                   block_k=blk)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[dtype])


def test_flash_attention_bf16_kernel_runs_on_the_tensor_cores(cuda):
    """The built flash library, disassembled: the bf16 kernels hold
    HMMA (tensor-core) instructions, the fp32 kernels none."""
    kernels = _sass_kernels("flash_attention")
    bf16 = [n for n in kernels if "flash_mma_kernel" in n]
    fp32 = [n for n in kernels if "flash_kernel" in n]
    assert len(bf16) == 2 and len(fp32) == 2, sorted(kernels)
    assert all(kernels[n] for n in bf16)
    assert not any(kernels[n] for n in fp32)


def test_flash_attention_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros((1, 1, 64, 96), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        fa.flash_attention(q[..., :64].half().contiguous(),
                           q[..., :64].half().contiguous(),
                           q[..., :64].half().contiguous())


# SSD scan: fp32 sums in other orders; bf16 y may differ by one bf16 ulp
GLA_Y_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=2e-5, rtol=2 ** -7)}
GLA_S_TOL = dict(atol=1e-5, rtol=1e-5)


# (B, H, T, N, P, chunk) of the scan's card tests; the launch plan of each
# is checked on the CPU (tests/test_torch_kernel_ops.py)
GLA_SHAPES = [
    (1, 1, 64, 8, 8, 16),         # tests/test_kernels.py's shapes
    (2, 3, 128, 16, 32, 32),
    (1, 2, 96, 32, 16, 32),
    (2, 1, 64, 64, 64, 64),
    (1, 4, 1024, 64, 64, 64),     # zamba2-7b's SSD head at a shorter T
    (1, 2, 64, 4, 12, 16),        # N 4, P 12: multiples of 4, not of 8
    (1, 2, 128, 32, 24, 32),      # P 24: a ragged 16-wide P slice
    (1, 8, 256, 64, 64, 64),      # 32 CTAs, fewer than the 132 SMs
    (2, 40, 256, 64, 64, 64),     # 320 CTAs
    (1, 4, 512, 64, 64, 16),      # chunk 16 and 32 at N = P = 64
    (1, 4, 512, 64, 64, 32),
    (1, 2, 256, 128, 64, 64),     # N at the tensor-core limit
    (1, 2, 256, 128, 64, 128),    # chunk past 64: bf16 on the fp32 pipes
    (1, 2, 120, 96, 40, 20),      # padded tile rows and chunk rows
    (1, 1, 64, 160, 8, 16),       # N past 128: bf16 on the fp32 pipes
]


def _gla_inputs(dev, B, H, T, N, P, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((B, H, T, N), generator=g, device=dev) * 0.5).to(dtype)
    k = (torch.randn((B, H, T, N), generator=g, device=dev) * 0.5).to(dtype)
    v = (torch.randn((B, H, T, P), generator=g, device=dev) * 0.5).to(dtype)
    logw = -torch.exp(torch.randn((B, H, T), generator=g, device=dev)
                      * 0.5 - 1.0)
    return q, k, v, logw


@pytest.mark.parametrize("B,H,T,N,P,chunk", GLA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_scan_kernel_matches_plain(cuda, B, H, T, N, P, chunk, dtype):
    q, k, v, logw = _gla_inputs(cuda, B, H, T, N, P, dtype, T + N + P)
    before = gla.gla_scan_scalar.launches
    y, s = ops.gla_scan_scalar(q, k, v, logw, chunk=chunk)
    torch.cuda.synchronize()
    assert gla.gla_scan_scalar.launches == before + 1
    want_y, want_s = gla.gla_scan_scalar_plain(q, k, v, logw, chunk=chunk)
    assert y.dtype == dtype and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), **GLA_Y_TOL[dtype])
    torch.testing.assert_close(s, want_s, **GLA_S_TOL)


@pytest.mark.parametrize("logw_value", [0.0, -30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_scan_kernel_decay_edges(cuda, logw_value, dtype):
    """No decay (logw 0: the state sums every step of T 1024 and grows)
    and a decay whose every exponent underflows (logw -30: each chunk
    keeps only its last step's state, A only its diagonal), at zamba2-7b's
    head shape, against the plain version."""
    q, k, v, _ = _gla_inputs(cuda, 1, 4, 1024, 64, 64, dtype, 7)
    logw = torch.full((1, 4, 1024), logw_value, device=cuda)
    y, s = ops.gla_scan_scalar(q, k, v, logw, chunk=64)
    want_y, want_s = gla.gla_scan_scalar_plain(q, k, v, logw, chunk=64)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y.float(), want_y.float(), **GLA_Y_TOL[dtype])
    torch.testing.assert_close(s, want_s, **GLA_S_TOL)


def test_gla_scan_kernel_is_deterministic(cuda):
    """Two launches on the same inputs are bit-equal: every sum runs in a
    fixed order, with no atomics."""
    args = _gla_inputs(cuda, 1, 8, 512, 64, 64, torch.bfloat16, 5)
    y1, s1 = gla.gla_scan_scalar(*args, chunk=64)
    y2, s2 = gla.gla_scan_scalar(*args, chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))
    assert torch.equal(s1.view(torch.int32), s2.view(torch.int32))


def test_gla_scan_bf16_kernel_runs_on_the_tensor_cores(cuda):
    """The built scan library, disassembled: the four instances of the
    bf16 kernel (N padded to 16, 32, 64, 128) hold HMMA (tensor-core)
    instructions; the fp32-pipe kernel is there for fp32 and bf16 alike."""
    kernels = _sass_kernels("gla_scan")
    mma = [n for n in kernels if "gla_scan_mma_kernel" in n]
    fma = [n for n in kernels if "gla_scan_fma_kernel" in n]
    assert len(mma) == 4 and len(fma) == 2, sorted(kernels)
    assert all(kernels[n] for n in mma)


def test_wrappers_never_fall_back_to_the_plain_version(cuda, monkeypatch):
    """With every plain version made to raise, each wrapper given CUDA
    tensors still returns the right result: it launched its kernel."""
    rng = np.random.default_rng(0)
    src, dst = _pool_pair(cuda, rng, 8, 8, 64, torch.bfloat16)
    si, di = [3, 1, 7], [0, 5, 2]
    runs = torch.tensor([0, 4, 3], dtype=torch.int32, device=cuda)
    starts = torch.tensor([2, 0, 2], dtype=torch.int32, device=cuda)
    want_copy = bc.block_copy_plain(src, dst.clone(), torch.tensor(si),
                                    torch.tensor(di))
    want_grouped = bc.block_copy_grouped_plain(src, dst.clone(), runs[:2],
                                               starts[:2], runs[1:], 3)
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((1, 2, 128, 128), generator=g, device=cuda)
               .bfloat16() for _ in range(3))
    want_fa = fa.flash_attention_plain(q, k, v)
    # the scan's inputs drawn as the tests above draw them, the scale its
    # fp32 tolerance is stated for
    gq, gk = (torch.randn((1, 2, 128, 64), generator=g, device=cuda) * 0.5
              for _ in range(2))
    gv = torch.randn((1, 2, 128, 32), generator=g, device=cuda) * 0.5
    glw = -torch.exp(torch.randn((1, 2, 128), generator=g, device=cuda)
                     * 0.5 - 1.0)
    want_y, want_s = gla.gla_scan_scalar_plain(gq, gk, gv, glw)
    a_rng = np.random.default_rng(3)
    a_np = _attention_case(a_rng, 4, 12, 2, 128, 16, 32, [0, 5, 300, 512])
    attn = (*_to(cuda, *a_np[:3]), *_to(cuda, *a_np[3:], dtype=torch.int32),
            128 ** -0.5, 4)
    want_pa = pa.paged_attention_plain(*attn)

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    for mod, name in ((bc, "block_copy_plain"),
                      (bc, "block_copy_grouped_plain"),
                      (fa, "flash_attention_plain"),
                      (gla, "gla_scan_scalar_plain"),
                      (pa, "paged_attention_plain")):
        monkeypatch.setattr(mod, name, refuse)
    out = ops.copy_blocks(src, dst.clone(), si, di)
    assert _bytes_equal(out, want_copy)
    out = bc.block_copy_grouped(src, dst.clone(), runs[:2], starts[:2],
                                runs[1:], 3)
    assert _bytes_equal(out, want_grouped)
    torch.testing.assert_close(ops.flash_attention(q, k, v).float(),
                               want_fa.float(),
                               **FLASH_TOL[torch.bfloat16])
    y, s = ops.gla_scan_scalar(gq, gk, gv, glw)
    torch.testing.assert_close(y, want_y, **GLA_Y_TOL[torch.float32])
    torch.testing.assert_close(s, want_s, **GLA_S_TOL)
    torch.testing.assert_close(ops.paged_attention(*attn).float(),
                               want_pa.float(), atol=ATOL, rtol=RTOL)
