#!/usr/bin/env python3
"""Dev loop: the port's engine in sim mode under the four policies.

    python3 scripts/torch_dev_engine.py [N] [--device {cuda,cpu}]

Samples N conversations (default 100, seed 1) and replays them through
``repro_torch``'s ``FastSwitchEngine`` in sim mode (2048 GPU / 8192 CPU
blocks, a Markov priority trace) under ``vllm``, ``+dbg``,
``+dbg+reuse`` and ``fastswitch``, one line each: p99 TTFT, p99.9 TBT,
throughput, tokens, iterations, preemptions, swap ops and blocks, stall,
blocks per op, and the swap-ins resumed from a short CPU copy
(``short_copy_resumes``).  The counterpart of ``scripts/dev_engine.py``.
Sim mode computes nothing on a device; ``--device`` (default ``cuda``)
keeps the port's rule that a script runs on the card unless asked for
the CPU, and exits non-zero without CUDA.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

POLICIES = ("vllm", "+dbg", "+dbg+reuse", "fastswitch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=100,
                    help="conversations to sample (default 100)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_dev_engine.py: no CUDA device; pass "
                         "--device cpu to run on the CPU")
    from repro_torch.core import EngineConfig, FastSwitchEngine
    from repro_torch.data.priority import PriorityTrace
    from repro_torch.data.sharegpt import sample_conversations, trace_stats

    convs = sample_conversations(args.n, seed=1)
    print("trace:", trace_stats(convs))
    for policy in POLICIES:
        cfg = EngineConfig(mode="sim", num_gpu_blocks=2048,
                           num_cpu_blocks=8192).with_policy(policy)
        trace = PriorityTrace(pattern="markov", update_freq=0.04, seed=7)
        eng = FastSwitchEngine(cfg, list(convs), trace=trace)
        m = eng.run(max_iterations=200_000)
        s = m.summary()
        sw = eng.swap.stats()
        print(f"{policy:12s} p99ttft={s['p99_ttft_ms']:9.1f}ms "
              f"p999tbt={s['p999_tbt_ms']:8.1f}ms "
              f"thr={s['throughput_tok_s']:7.1f} "
              f"tok={s['total_tokens']} iters={s['iterations']} "
              f"preempt={s['preemptions']} ops={sw['total_ops']} "
              f"blocks={sw['total_blocks']} "
              f"stall={sw['total_stall_us'] / 1e6:.2f}s "
              f"gran={sw['total_blocks'] / max(sw['total_ops'], 1):.1f} "
              f"short_copy_resumes="
              f"{eng.reuse.stats()['short_copy_resumes']}", flush=True)
        eng.swap.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
