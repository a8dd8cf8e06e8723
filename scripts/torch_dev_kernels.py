#!/usr/bin/env python3
"""Dev loop: the port's hand-written kernels against their plain twins.

    python3 scripts/torch_dev_kernels.py [--device {cuda,cpu}]

The counterpart of ``scripts/dev_kernels.py``, with its batch, pages,
contexts and index pairs: paged attention (B 3, a table of 4 pages of 16
tokens over a 32-block pool, contexts 5 / 33 / 64, 8 query heads over 2
KV heads), ``block_copy`` (three index pairs from a 16-block pool into a
12-block one, 128 elements a block) and ``block_copy_grouped`` (runs of
2 and 4 blocks, 4 steps a run).  Each wrapper's output against its plain
PyTorch version on the same inputs, one max-error line per kernel (the
wrapper launches the CUDA kernel on ``--device cuda``, the default, and
runs the plain version itself on ``--device cpu``), then on CUDA each
wrapper's launch count.  Exits 1 where a copy is not byte-equal or an
attention element is past ``ATOL + RTOL * |ref|``.

Paged attention runs the reference script's own case, fp32 with head_dim
64 (on CUDA the fp32 kernel of ``csrc/paged_attention.cu``), held to
1e-5 as the reference holds its fp32 kernel sweep.  Exits non-zero
without CUDA unless ``--device cpu`` is given.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

# scripts/dev_kernels.py's paged-attention case
B, Hq, Hkv, D, bs, nb, npages = 3, 8, 2, 64, 16, 32, 4
DTYPE = "float32"
# its bound, per element: |out - ref| <= ATOL + RTOL * |ref| (exact fp32
# products summed in another order: tests/test_kernels.py's fp32 bound)
ATOL, RTOL = 1e-5, 1e-5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_dev_kernels.py: no CUDA device; pass "
                         "--device cpu to run on the CPU")
    from repro_torch.kernels import block_copy as bc
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import block_copy_ref
    dev = torch.device(args.device)
    g = torch.Generator().manual_seed(0)

    def normal(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dev, dtype)

    dtype = getattr(torch, DTYPE)
    q = normal(B, Hq, D, dtype=dtype)
    kp = normal(nb, bs, Hkv, D, dtype=dtype)
    vp = normal(nb, bs, Hkv, D, dtype=dtype)
    bt = torch.randperm(nb, generator=g)[:B * npages].reshape(
        B, npages).to(dev, torch.int32)
    ctx = torch.tensor([5, 33, 64], dtype=torch.int32, device=dev)
    scale = D ** -0.5
    ref = pa.paged_attention_plain(q, kp, vp, bt, ctx, scale)
    out = pa.paged_attention(q, kp, vp, bt, ctx, scale)
    diff = (ref.float() - out.float()).abs()
    print("paged_attention maxerr", float(diff.max()), flush=True)
    if not bool((diff <= ATOL + RTOL * ref.float().abs()).all()):
        print(f"paged_attention: an element past {ATOL} + {RTOL} * |ref|",
              file=sys.stderr)
        return 1

    E = 128
    src = normal(16, E)
    dst = torch.zeros(12, E, device=dev)
    si = torch.tensor([3, 7, 1], dtype=torch.int32, device=dev)
    di = torch.tensor([0, 5, 11], dtype=torch.int32, device=dev)
    ref2 = block_copy_ref(src, dst, si, di)
    out2 = bc.block_copy(src, dst.clone(), si, di)
    print("block_copy maxerr", float((ref2 - out2).abs().max()), flush=True)

    ss = torch.tensor([0, 8], dtype=torch.int32, device=dev)
    ds = torch.tensor([2, 6], dtype=torch.int32, device=dev)
    ls = torch.tensor([2, 4], dtype=torch.int32, device=dev)
    ref3 = bc.block_copy_grouped_plain(src, dst.clone(), ss, ds, ls,
                                       run_blocks=4)
    out3 = bc.block_copy_grouped(src, dst.clone(), ss, ds, ls, run_blocks=4)
    print("block_copy_grouped maxerr", float((ref3 - out3).abs().max()),
          flush=True)
    if dev.type == "cuda":
        print("launches", json.dumps({
            "paged_attention": pa.paged_attention.launches,
            "block_copy": bc.block_copy.launches,
            "block_copy_grouped": bc.block_copy_grouped.launches}),
            flush=True)
    return 0 if float((ref2 - out2).abs().max()) == 0 == \
        float((ref3 - out3).abs().max()) else 1


if __name__ == "__main__":
    sys.exit(main())
