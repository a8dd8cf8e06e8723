#!/usr/bin/env python3
"""Run chip_smoke's ``examples`` phase alone on one GPU.

    python3 scripts/examples_probe.py

``chip_smoke.py`` runs its ``examples`` phase through this script, in a
process of its own.

Builds the kernels, then, through chip_smoke's ``examples_phase``, serves
``examples/torch_quickstart.py``'s workload in process with llama3.2-3b
at full width (28 layers, d_model 3072, 24/8 heads of 128, random bf16
weights from seed 0): every turn finished, preemption, swaps both ways,
no copy retried or failed, greedy tokens against the dense forward, the
serving kernels' launches, wall and host seconds by method; then runs
``examples/torch_quickstart.py`` and ``examples/torch_train_lm.py
--steps 50`` as subprocesses.  Prints the card's name and power limit,
then the phase's JSON line.  Needs a GPU; imports nothing of JAX.
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
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("examples_probe.py needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    cs.emit("examples", nvidia_smi=smi,
            **cs.examples_phase(torch.device("cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
