#!/usr/bin/env python3
"""Run chip_smoke's ``ladder`` phase alone.

    python3 scripts/ladder_probe.py               # on one GPU, full width
    python3 scripts/ladder_probe.py --device cpu  # the reduced config

Through chip_smoke's ``ladder_phase``, serves the engine phase's workload
(8 two-turn conversations, 160 GPU and 1024 CPU blocks of 16 tokens, the
priority storm of seed 13) with mistral-nemo-12b under the paper's four
policies (vllm, +dbg, +dbg+reuse, fastswitch), each a fresh engine on one
bundle.  On ``cuda`` (the default) the model is the published config at
full width (40 layers, d_model 5120, 32 / 8 heads of 128, d_ff 14336,
vocab 131072) from random bf16 serving weights drawn on the card with
seed 0, and the kernels are built first; ``--device cpu`` serves its
reduced config with the kernels' plain versions.  Every policy's swaps
are held byte for byte, its tokens against the dense forward, and every
two policies' tokens against each other.  Prints the card's name and
power limit (on ``cuda``), then the phase's JSON line.  Imports nothing
of JAX.  ``chip_smoke.py`` runs the phase in its own process, right
after its reuse phase.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import transformer as T
    smi = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("ladder_probe.py needs an NVIDIA GPU "
                             "(--device cpu for the reduced config)")
        from repro_torch.kernels import build
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        print(smi, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build()
        cfg = get_config(cs.LADDER_ARCH)
    else:
        cfg = get_smoke_config(cs.LADDER_ARCH)
    t0 = time.perf_counter()
    bundle = {"cfg": cfg, "params": T.init_params(
        cfg, seed=cs.SEED, device=args.device, serving=True)}
    init_s = time.perf_counter() - t0
    convs = cs.conversations(8, (256, 288, 320, 352), (96, 128, 160),
                             max_tokens=32)
    sizes = dict(gpu_blocks=160, cpu_blocks=1024, max_running=8)
    res = cs.ladder_phase(bundle, convs, sizes)
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if args.device == "cuda" else None)
    cs.emit("ladder", nvidia_smi=smi, device=args.device,
            seconds=time.perf_counter() - t0, init_s=init_s,
            peak_gb=peak, **res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
