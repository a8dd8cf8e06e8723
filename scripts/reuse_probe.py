#!/usr/bin/env python3
"""Run chip_smoke's ``reuse`` phase alone on one GPU.

    python3 scripts/reuse_probe.py

Builds the kernels, then, through chip_smoke's ``reuse_phase``, serves
the engine phase's workload with qwen2-1.5b at full width (random fp32
weights from seed 0, as the engine phase) over 160 GPU blocks and a host
pool of 256, then 192, blocks: every turn finished, no block restored
past a CPU copy's valid prefix, at least one short copy resumed, every
greedy token the dense argmax or a near-tie, each serving kernel
launched.  Prints the card's name and power limit, then the phase's JSON
line.  Needs a GPU; imports nothing of JAX.  ``chip_smoke.py`` runs the
phase in its own process, right after its control phase.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    if not torch.cuda.is_available():
        raise SystemExit("reuse_probe.py needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    cfg = get_config(cs.ARCH)
    bundle = {"cfg": cfg, "params": T.init_params(cfg, seed=cs.SEED,
                                                  device="cuda")}
    convs = cs.conversations(8, (256, 288, 320, 352), (96, 128, 160),
                             max_tokens=32)
    sizes = dict(gpu_blocks=160, cpu_blocks=1024, max_running=8)
    t0 = time.perf_counter()
    res = cs.reuse_phase(bundle, convs, sizes)
    cs.emit("reuse", nvidia_smi=smi, seconds=time.perf_counter() - t0,
            **res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
