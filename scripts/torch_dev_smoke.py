#!/usr/bin/env python3
"""Dev loop: forward, train step, prefill and decode for each smoke arch.

    python3 scripts/torch_dev_smoke.py [ARCH ...] [--device {cuda,cpu}]

The counterpart of ``scripts/dev_smoke.py``.  For each arch named (all
ten of the registry by default), its reduced config with seed-0 weights
from ``repro_torch.models.transformer.init_params``: a batch of B 2 x T
32 random tokens (with ones for a VLM's image embeddings or an
encoder-decoder's frames), one AdamW ``train_step`` (finite loss), a
``prefill`` (finite (B, V) logits), ``caches_from_prefill`` to 64
positions and 3 greedy ``serve_step``s (finite logits).  One line per
arch: ``OK`` with its parameter count and loss, or ``FAIL`` with the
error; exits non-zero if any arch failed.  Runs on ``--device cuda`` (the
default; exits non-zero without CUDA) or ``--device cpu``.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def smoke(arch: str, device) -> str:
    """One arch's forward, train step, prefill and 3 decode steps; returns
    its summary line or raises."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import steps, transformer as T
    from repro_torch.train.optimizer import adamw_init, tree_leaves

    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, seed=0, device=device)
    n = sum(x.numel() for x in tree_leaves(params))
    B, S = 2, 32
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g).to(device)
    batch = {"tokens": tokens, "labels": tokens}
    vision = cfg.frontend is not None and cfg.frontend.kind == "vision"
    if vision:
        batch["extra_embeds"] = torch.ones(
            (B, cfg.frontend.n_tokens, cfg.frontend.d_embed), device=device)
    if cfg.encoder_decoder:
        batch["encoder_frames"] = torch.ones(
            (B, cfg.n_encoder_tokens, cfg.d_model), device=device)
    opt = adamw_init(params)
    params, opt, loss = steps.train_step(params, opt, batch, cfg=cfg)
    if not torch.isfinite(loss):
        raise AssertionError(f"loss not finite: {float(loss)}")
    with torch.no_grad():
        logits, raw = steps.prefill(
            params, cfg, tokens, extra_embeds=batch.get("extra_embeds"),
            encoder_frames=batch.get("encoder_frames"))
        if tuple(logits.shape) != (B, cfg.vocab_size):
            raise AssertionError(f"prefill logits {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill logits not finite")
        caches = steps.caches_from_prefill(cfg, raw, B, 64)
        tok = torch.argmax(logits, -1).to(torch.int32)
        pos = S + (cfg.frontend.n_tokens if vision else 0)
        for i in range(3):
            tok, lg, caches = steps.serve_step(params, caches, tok, pos + i,
                                               cfg=cfg)
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"decode {i} not finite")
    return f"OK   {arch:26s} params={n:,} loss={float(loss):.3f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("archs", nargs="*", help="archs (default: all ten)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_dev_smoke.py: no CUDA device; pass "
                         "--device cpu to run on the CPU")
    from repro_torch.configs import list_archs
    failed = 0
    for arch in args.archs or list_archs():
        try:
            print(smoke(arch, torch.device(args.device)), flush=True)
        except Exception as e:
            failed += 1
            print(f"FAIL {arch}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
