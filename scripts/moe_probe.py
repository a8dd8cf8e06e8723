#!/usr/bin/env python3
"""Run chip_smoke's ``moe`` phase alone on one GPU.

    python3 scripts/moe_probe.py [--profile]

``chip_smoke.py`` runs its ``moe`` phase through this script, in a
process of its own.

Builds the kernels, then serves olmoe-1b-7b at full width through
chip_smoke's ``moe_phase``: the warm-up and timed engine runs, the oracle
step (CUDA paged attention against its plain version, every active row's
record), one replay's time beside its bound (with ``--profile`` also its
kernels by device time under ``torch.profiler``), peak memory, and the
launcher's run as a subprocess.  Prints the card's name and power limit,
then the phase's JSON line.  Needs a GPU; imports nothing of JAX.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("moe_probe.py needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    with tempfile.TemporaryDirectory() as tmp:
        out = cs.moe_phase(torch.device("cuda"), Path(tmp),
                           profile="--profile" in sys.argv[1:])
    cs.emit("moe", nvidia_smi=smi, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
