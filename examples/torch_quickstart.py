"""Quickstart: serve Llama-3.2-3B with FastSwitch through the PyTorch port.

The port's counterpart of ``examples/quickstart.py``: the same six
two-turn conversations, engine configuration, priority trace and printed
lines.  Real tokens flow through the paged KV pool (the hand-written
paged attention kernel, a CUDA graph per decode bucket), with
priority-driven preemption, block-group swaps through the staged swap
plane and KV reuse across conversation turns.

  * ``--device cuda`` (the default) serves llama3.2-3b's published
    config at full width (28 layers, d_model 3072, 24/8 heads of 128,
    vocab 128256) from random bf16 weights drawn with seed 0 on the card;
  * ``--device cpu`` serves its reduced config, as the reference's
    quickstart does.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import EngineConfig, FastSwitchEngine
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import Conversation, Turn
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import tree_leaves

ARCH = "llama3.2-3b"


def conversations():
    """Six conversations, each a 16-token prompt answered in 12 tokens,
    then an 8-token follow-up answered in 12, one second of think time
    between, arriving 0.2 s apart."""
    return [
        Conversation(conv_id=i, arrival_s=0.2 * i,
                     turns=[Turn(prompt_tokens=16, response_tokens=12),
                            Turn(prompt_tokens=8, response_tokens=12)],
                     think_time_s=1.0)
        for i in range(6)
    ]


def build(device: str = "cuda", params=None) -> FastSwitchEngine:
    """The quickstart's engine on ``device``: llama3.2-3b's published
    config on ``cuda`` (no CPU fallback: ``SystemExit`` without a GPU),
    its reduced config on ``cpu``.  ``params`` overrides the seed-0
    serving weights (tests pass the reference's, converted)."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is "
                             "false; pass --device cpu to serve the "
                             "reduced model on the CPU")
        cfg = get_config(ARCH)
    else:
        cfg = get_smoke_config(ARCH)
    if params is None:
        params = T.init_params(cfg, seed=0, device=device, serving=True)
    engine_cfg = EngineConfig(
        mode="real", num_gpu_blocks=96, num_cpu_blocks=512,
        max_running=4, max_batch=4).with_policy("fastswitch")
    return FastSwitchEngine(
        engine_cfg, conversations(),
        trace=PriorityTrace("markov", update_freq=0.05, seed=1),
        model_bundle={"cfg": cfg, "params": params})


def report(engine: FastSwitchEngine, metrics) -> None:
    """The reference quickstart's summary lines."""
    s = metrics.summary()
    sw = engine.swap.stats()
    print(f"served {s['total_tokens']} tokens over {s['iterations']} iters")
    print(f"p99 TTFT {s['p99_ttft_ms']:.1f} ms   "
          f"p99 TBT {s['p99_tbt_ms']:.2f} ms (modelled A10 latency)")
    print(f"preemptions {s['preemptions']}  swap ops {sw['total_ops']}  "
          f"avg granularity {sw['total_blocks'] / max(sw['total_ops'], 1):.1f} "
          f"blocks/op")
    for cid, hist in sorted(engine._token_hist_by_conv.items()):
        print(f"conv {cid}: ...{hist[-6:]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda serves the published config on the GPU; "
                         "cpu the reduced one")
    args = ap.parse_args(argv)
    engine = build(args.device)
    cfg = engine.runner.mb["cfg"]
    n = sum(x.numel() for x in tree_leaves(engine.runner.mb["params"]))
    print(f"model: {cfg.name}  ({n:,} params)")
    report(engine, engine.run())


if __name__ == "__main__":
    main()
