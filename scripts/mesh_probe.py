#!/usr/bin/env python3
"""Run chip_smoke's ``mesh`` phase alone on one GPU.

    python3 scripts/mesh_probe.py

``chip_smoke.py`` runs its ``mesh`` phase through this script, in a
process of its own.

Builds the kernels, then, through chip_smoke's ``mesh_phase``, serves
qwen2-1.5b whole on a (1, 2) mesh and olmoe-1b-7b whole on a (1, 4) mesh,
every shard on the one card (an explicit device list with repeats), each
beside the same workload on one device: the held swap counts, one host
transfer per staged chunk per shard, each bucket's first replay against
its eager step, the per-shard kernel launches, tokens against the
one-device run, the oracle step, the engine bucket's attention per
shard, one staged swap across the meshes, the sampled batch on (1, 2),
and the engine's refusals of a mesh over two devices.  Prints the card's
name and power limit, then the phase's JSON line.  Needs a GPU; imports
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
        raise SystemExit("mesh_probe.py needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    cs.emit("mesh", nvidia_smi=smi, **cs.mesh_phase(torch.device("cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
