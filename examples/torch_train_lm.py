"""Scenario: end-to-end training driver through the PyTorch port — train
a reduced (~1-10M param) model on a learnable synthetic task, watch the
loss drop, and round-trip a checkpoint byte for byte.

The port's counterpart of ``examples/train_lm.py``: the same reduced
configs, task (next token = (token + 1) % 64), AdamW at lr 1e-3 with
remat off, and printed lines.  ``--device`` defaults to ``cuda``;
``--device cpu`` trains on the CPU.  Each step's batch is drawn with
numpy from (seed, step), so both packages can be fed the same batches.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 50
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import steps as S
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.optimizer import adamw_init, tree_leaves

# next token = (token + 1) % ALPHABET: the loss should fall well below
# ln(ALPHABET)
ALPHABET = 64
LR = 1e-3


def make_batch(i: int, batch: int, seq: int, seed: int = 0) -> dict:
    """Step ``i``'s batch as numpy int64 arrays: rows counting up from a
    random start, modulo the alphabet; labels are tokens shifted by one."""
    rng = np.random.default_rng([seed, i])
    start = rng.integers(0, ALPHABET, (batch, 1))
    seq_ = (start + np.arange(seq + 1)[None, :]) % ALPHABET
    return {"tokens": seq_[:, :-1], "labels": seq_[:, 1:]}


def train(cfg, params, *, steps: int, batch: int, seq: int, device,
          log_every: int = 20):
    """``steps`` AdamW steps (lr 1e-3, remat off) from ``params`` on
    ``device``; returns (params, losses)."""
    opt = adamw_init(params)
    losses = []
    t0 = time.time()
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in make_batch(i, batch, seq).items()}
        params, opt, loss = S.train_step(params, opt, b, cfg=cfg, lr=LR,
                                         remat=False)
        losses.append(float(loss))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return params, losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--checkpoint", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt.npz"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is "
                         "false; pass --device cpu to train on the CPU")

    cfg = get_smoke_config(args.arch)
    device = torch.device(args.device)
    params, _ = S.init_train_state(cfg, seed=0, device=device)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"{cfg.name}: {n:,} params")
    params, losses = train(cfg, params, steps=args.steps, batch=args.batch,
                           seq=args.seq, device=device)
    first, last = losses[0], losses[-1]
    if not last < first:
        raise SystemExit(f"loss did not improve: {first:.4f} -> {last:.4f}")
    save_checkpoint(args.checkpoint, params)
    restored = load_checkpoint(args.checkpoint, params)
    if not all(torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(restored))):
        raise SystemExit("checkpoint round-trip changed a tensor")
    print(f"loss {first:.3f} -> {last:.3f}; checkpoint round-trip OK "
          f"({args.checkpoint})")


if __name__ == "__main__":
    main()
