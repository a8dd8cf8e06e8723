"""Scenario: fairness under frequent priority updates — the vLLM baseline
against ``+dbg``, ``+dbg+reuse`` and FastSwitch on the paper's
LLaMA-8B/A10 serving scenario (trace-driven, sim mode), through the
PyTorch port.

The port's counterpart of ``examples/fairness_comparison.py``: the same
scenario, policies, header and per-policy line (p95 / p99 TTFT, p99.9
TBT on the A10 cost model's clock, throughput, swap operations, stall).
Takes no flags; runs on the CPU in about half a minute.

    PYTHONPATH=src python examples/torch_fairness_comparison.py
"""
from repro_torch.launch.scenarios import POLICY_ORDER, run_policy

HEADER = (f"{'policy':14s} {'p95 TTFT':>12s} {'p99 TTFT':>12s} "
          f"{'p99.9 TBT':>12s} {'tok/s':>8s} {'swap ops':>9s} {'stall':>9s}")


def policy_line(policy: str, summary: dict, swap_stats: dict) -> str:
    """One policy's line from its engine's ``metrics.summary()`` and
    ``swap.stats()``."""
    s, sw = summary, swap_stats
    return (f"{policy:14s} {s['p95_ttft_ms']:10.0f} ms "
            f"{s['p99_ttft_ms']:10.0f} ms {s['p999_tbt_ms']:10.0f} ms "
            f"{s['throughput_tok_s']:8.1f} {sw['total_ops']:9d} "
            f"{sw['total_stall_us'] / 1e6:7.1f}s")


def main():
    print(HEADER)
    for pol in POLICY_ORDER:
        eng = run_policy("llama8b-a10", pol, pattern="markov")
        print(policy_line(pol, eng.metrics.summary(), eng.swap.stats()))
    print("\nspeedups are FastSwitch's contribution: block-group I/O, "
          "KV reuse, async swapping")


if __name__ == "__main__":
    main()
