#!/usr/bin/env python3
"""Run chip_smoke's ``families`` phase alone on one GPU.

    python3 scripts/families_probe.py

``chip_smoke.py`` runs its ``families`` phase through this script, in a
process of its own.

Builds the kernels (none of them is on these families' path: their
attention is plain PyTorch, as the reference's is plain XLA), then,
through chip_smoke's ``families_phase``, at full width and the depth
of ``FAMILIES_DEPTH``: serves gemma3-12b cut to one period (6 layers)
from its bf16 serving init (prefills of 4 x 1500 and 1 x
5000 tokens, 32 greedy decode steps each past the local rings' wrap,
the rings' slots checked, tokens against the dense forward; times, a
profiled step, its bound, peak memory), trains its one-period cut for 8
steps and holds its smoke config's gradients on the card to the CPU's;
serves deepseek-v2-236b cut to 2 layers (a prefill of 4 x 512, 32
absorbed-weight MLA decode steps, layer 0's decode against its sequence
forward, tokens counted against the dense forward) and holds its smoke
config's gradients to the CPU's; trains and decodes whisper-large-v3
cut to 4 + 4 layers through chip_smoke's ``train_phase``, its launcher
(the whole model) as a subprocess; and checks the launchers' refusals.  Prints the card's name
and power limit, then the phase's JSON line.  Needs a GPU; imports
nothing of JAX.
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
        raise SystemExit("families_probe.py needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    cs.emit("families", nvidia_smi=smi,
            **cs.families_phase(torch.device("cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
