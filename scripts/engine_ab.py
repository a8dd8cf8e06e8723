#!/usr/bin/env python3
"""Time chip_smoke's engine phase of several checkouts, in turn, on one GPU.

    python3 scripts/engine_ab.py [--profile] LABEL=ROOT [LABEL=ROOT ...]

Each ROOT is the root of a checkout of this repository (for instance the
parent commit unpacked with ``git archive`` into a git-ignored directory,
and ``.`` for the working tree).  The checkouts run in the order given,
each in a process of its own that imports only that checkout's
``chip_smoke.py`` and ``repro_torch`` and builds its kernels anew: the
warm-up engine run, then the timed run (wall seconds ending in a device
synchronise, tokens/s, host seconds by method, the runner's step
counts), and with ``--profile`` one more run under ``torch.profiler``
(the device's idle share of its wall).  Give the checkouts in turns
(parent, change, change, parent) to compare them on one card.

Prints the card's name and power limit, then one JSON line per run.
Needs a GPU; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def one(label: str, root: str, profile: bool) -> dict:
    """The engine phase of the checkout at ``root``, in this process."""
    root_p = Path(root).resolve()
    sys.path[:0] = [str(root_p), str(root_p / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import block_copy as bc
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer as T
    if not torch.cuda.is_available():
        raise SystemExit("engine_ab.py needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(["paged_attention", "block_copy"])
    cfg = get_config(cs.ARCH)
    bundle = {"cfg": cfg,
              "params": T.init_params(cfg, seed=cs.SEED, device="cuda")}
    convs = cs.conversations(8, (256, 288, 320, 352), (96, 128, 160),
                             max_tokens=32)
    sizes = dict(gpu_blocks=160, cpu_blocks=1024, max_running=8)
    cold, cold_wall, _, cold_swaps = cs.run_engine(bundle, convs, **sizes)
    cs.check_engine(cold, convs, cold_swaps)
    del cold
    pa.paged_attention.launches = 0
    bc.block_gather_runs.launches = 0
    bc.block_scatter_runs.launches = 0
    eng, wall, host, swaps = cs.run_engine(bundle, convs, **sizes)
    stats = cs.check_engine(eng, convs, swaps)
    out = {"label": label, "root": str(root_p), "wall_s": wall,
           "cold_wall_s": cold_wall, "tokens_per_s": stats["tokens"] / wall,
           "host_s_by_method": host,
           "launches": {"paged_attention": pa.paged_attention.launches,
                        "block_gather_runs": bc.block_gather_runs.launches,
                        "block_scatter_runs": bc.block_scatter_runs.launches},
           **{k: stats.get(k) for k in (
               "decode_steps", "graphs_captured", "graph_replays",
               "eager_steps", "preemptions", "swap_out_calls",
               "swap_in_calls", "copy_retries", "copy_failures")}}
    del eng
    if profile:
        prof = cs.profile_engine(bundle, convs, **sizes)
        out["profile"] = {k: prof[k] for k in (
            "wall_s", "device_busy_s", "device_idle_share", "device_ops",
            "paged_attention_ms", "paged_attention_ops")}
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        label, root, profile = argv[1], argv[2], argv[3] == "1"
        print(json.dumps(one(label, root, profile)), flush=True)
        return 0
    profile = "--profile" in argv
    runs = [a.split("=", 1) for a in argv if a != "--profile"]
    if not runs or any(len(r) != 2 for r in runs):
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    failed = 0
    for label, root in runs:
        proc = subprocess.run(
            [sys.executable, __file__, "--one", label, root,
             "1" if profile else "0"], capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            failed += 1
            print(json.dumps({"label": label, "root": root,
                              "rc": proc.returncode,
                              "stderr_tail": proc.stderr[-3000:]}),
                  flush=True)
            continue
        print(json.dumps(dict(json.loads(lines[-1]), nvidia_smi=smi)),
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
