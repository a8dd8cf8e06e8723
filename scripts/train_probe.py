#!/usr/bin/env python3
"""Run chip_smoke's ``train`` phase alone on one GPU.

    python3 scripts/train_probe.py

``chip_smoke.py`` runs its ``train`` phase through this script, in a
process of its own.

Trains qwen2-1.5b at full width (fp32 parameters and AdamW state) through
chip_smoke's ``train_phase``: 8 steps on one batch (B 8 x T 128, remat
on) whose loss must fall, remat on against off, the card against the CPU
at 2 layers, greedy decode through ``prefill`` / ``caches_from_prefill``
/ ``serve_step`` against the dense forward (bf16 and int8 caches), the
step's times, FLOPs and peak memory, and the launcher
``python -m repro_torch.launch.train`` as a subprocess.  Prints the
card's name and power limit, then the phase's JSON line.  Needs a GPU;
imports nothing of JAX.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("train_probe.py needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.emit("train", nvidia_smi=smi, **cs.train_phase(torch.device("cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
