#!/usr/bin/env python3
"""Run chip_smoke's ``ssm`` phase alone on one GPU.

    python3 scripts/ssm_probe.py

``chip_smoke.py`` runs its ``ssm`` phase through this script, in a
process of its own.

Builds the kernels, then, through chip_smoke's ``ssm_phase``, at full
width and the depth of ``SSM_DEPTH``: serves zamba2-7b cut to one period
and its remainder layers (bf16 serving copy; a prefill of 8 prompts of
256 with the SSD scan kernel once per Mamba2 layer, 8 launches, against the
same prefill with the kernel's plain version; 32 greedy decode steps
against the dense forward; times, the scan at the prefill's shape, a
profiled decode step, peak memory), trains its one-period cut against the
CPU, trains and decodes rwkv6-1.6b cut to 4 layers (chip_smoke's
``train_phase``, its launcher on the whole model as a subprocess), and
checks that the
launchers refuse zamba2-7b's training state and real-mode serving.
Prints the card's name and power limit, then the phase's JSON line.
Needs a GPU; imports nothing of JAX.
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
        raise SystemExit("ssm_probe.py needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    cs.emit("ssm", nvidia_smi=smi, **cs.ssm_phase(torch.device("cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
