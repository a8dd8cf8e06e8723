#!/usr/bin/env python3
"""Run chip_smoke's ``reduced`` phase alone.

    python3 scripts/reduced_probe.py               # on one GPU
    python3 scripts/reduced_probe.py --device cpu  # both runs on the CPU

Through chip_smoke's ``reduced_phase``, serves the reference's real-mode
models, the reduced configs of the five archs the paged path serves
(qwen2-1.5b, olmoe-1b-7b, llama3.2-3b, mistral-nemo-12b,
llava-next-mistral-7b: d_model 256, 2 layers, heads of 64), on the engine
phase's workload (8 two-turn conversations, 160 GPU and 1024 CPU blocks
of 16 tokens, the priority storm of seed 13) under vllm and fastswitch.
Each run on the card (the default; the kernels are built first) is held
to the same run on the host's CPU with the same bf16 weights, drawn once
from seed 0 on the CPU: swap ops equal, every staged swap byte-equal,
every stream equal or parting at a near-tie, paged attention launched.
Beside them, the launcher's ``--online --smoke --real --device cuda
--reduced``.
Prints the card's name and power limit (on ``cuda``), then the phase's
JSON line.  Imports nothing of JAX.  ``chip_smoke.py`` calls the same
phase in its process, right after its control phase.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
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
    smi = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("reduced_probe.py needs an NVIDIA GPU "
                             "(--device cpu runs both sides on the CPU)")
        from repro_torch.kernels import build
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        print(smi, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = cs.reduced_phase(torch.device(args.device), Path(tmp))
    cs.emit("reduced", nvidia_smi=smi, device=args.device,
            probe_seconds=time.perf_counter() - t0, **res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
