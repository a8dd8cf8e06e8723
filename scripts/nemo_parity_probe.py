#!/usr/bin/env python3
"""mistral-nemo-12b at full width, cut in depth, through both packages'
engines on the CPU: do the port's greedy streams part from the
reference's only at near-ties?

    PYTHONPATH=src python scripts/nemo_parity_probe.py [--conversations 8]

The chip harness's ``ladder`` phase serves mistral-nemo-12b (d_model
5120, 32 / 8 heads of 128: a head_dim that is not d_model / n_heads)
under the paper's four policies; there a few greedy tokens fall 0.05-0.1
below the dense forward's maximum, which its own bf16 rounding can
explain.  This probe asks the question of the two engines directly: the
published config cut to 2 layers, every width kept (vocab 131072), the
reference's weights (``init_params(cfg, PRNGKey(0))``) and the same
leaves for the port (its bf16 serving copy), the ladder's workload
(``--conversations`` two-turn conversations of prompts 256-352 then
96-160 tokens, 32 generated a turn, 160 GPU and 1024 CPU blocks of 16
tokens, 8 running, the priority storm of seed 13), both packages' swap
tasks held to the simulated clock.  Per policy of the paper's ladder
(``POLICY_ORDER``), each conversation's port stream against the
reference engine's: equal, or the first parting with the top-2 gap of
the port's dense forward over the shared prefix there; a parting at a
gap of ``NEAR_TIE`` (0.05) or more is a fault.

A CPU probe: it imports both packages, as the tests do, and needs about
16 GB of host memory (the reference's fp32 weights, 7.5 GB, beside the
port's serving copy).  Prints one JSON line per policy and a summary;
exits 1 at a fault.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NEAR_TIE = 5e-2
ARCH = "mistral-nemo-12b"
LAYERS = 2


def conversations(conv_cls, turn_cls, n: int) -> list:
    """The ladder's workload (``chip_smoke.conversations``), as the given
    package's conversations."""
    prompts, followups = (256, 288, 320, 352), (96, 128, 160)
    return [conv_cls(conv_id=i, arrival_s=0.0,
                     turns=[turn_cls(prompts[i % 4], 32),
                            turn_cls(followups[i % 3], 32)],
                     think_time_s=0.05) for i in range(n)]


def run(pkg, bundle, policy: str, n_convs: int) -> tuple:
    """(histories, seconds, swap ops) of one real-mode run of the
    workload by package ``pkg`` ("repro" or "repro_torch")."""
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    share = importlib.import_module(f"{pkg}.data.sharegpt")
    prio = importlib.import_module(f"{pkg}.data.priority")
    cfg = core.EngineConfig(mode="real", num_gpu_blocks=160,
                            num_cpu_blocks=1024, max_running=8,
                            max_batch=8, block_size=16,
                            seed=0).with_policy(policy)
    eng = core.FastSwitchEngine(
        cfg, conversations(share.Conversation, share.Turn, n_convs),
        trace=prio.PriorityTrace("random", 0.5, seed=13),
        model_bundle=bundle)
    t0 = time.perf_counter()
    eng.run(max_iterations=100_000)
    seconds = time.perf_counter() - t0
    if not eng.done():
        raise AssertionError(f"{pkg} {policy}: the engine did not finish")
    hists = {cid: list(h) for cid, h in eng._token_hist_by_conv.items()}
    sw = eng.swap.stats()
    eng.shutdown()
    print(f"{pkg} {policy}: {seconds:.1f} s", file=sys.stderr, flush=True)
    return hists, seconds, [sw["ops_out"], sw["ops_in"]]


def first_parting(bundle, a: list, b: list):
    """(position, top-2 logit gap of the port's dense forward over the
    shared prefix) where ``a`` and ``b`` first differ; None if equal."""
    import torch
    from repro_torch.models import transformer as T
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            with torch.no_grad():
                logits, _, _ = T.forward_seq(
                    bundle["params"], bundle["cfg"],
                    torch.tensor([a[:i]], dtype=torch.long), last_only=True)
            top = torch.topk(logits[0, -1].float(), 2).values
            return i, float(top[0] - top[1])
    if len(a) != len(b):
        raise AssertionError("one history is a prefix of the other")
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--conversations", type=int, default=8)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import jax
    import numpy as np
    import chip_smoke
    from repro.configs import get_config as jax_get_config
    from repro.core import swap_manager as jax_swap
    from repro.models import transformer as jax_T
    from repro_torch.configs import get_config
    from repro_torch.core import swap_manager
    from repro_torch.launch.scenarios import POLICY_ORDER
    from repro_torch.models import transformer as T
    policies = list(POLICY_ORDER)
    t0 = time.perf_counter()
    jcfg = jax_get_config(ARCH).reduced(n_layers=LAYERS)
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    port = {"cfg": get_config(ARCH).reduced(n_layers=LAYERS),
            "params": T.serving_params(T.params_from_numpy(
                jax.tree.map(np.asarray, jparams), device="cpu"))}
    init_s = time.perf_counter() - t0
    ref = {}
    with chip_smoke.swaps_follow_the_clock(jax_swap, swap_manager):
        for pol in policies:
            ref[pol] = run("repro", {"cfg": jcfg, "params": jparams}, pol,
                           args.conversations)
        del jparams
        ours = {pol: run("repro_torch", port, pol, args.conversations)
                for pol in policies}
    faults, lines = [], []
    for pol in policies:
        (rh, rs, rops), (th, ts, tops) = ref[pol], ours[pol]
        parts = {}
        for cid, want in sorted(rh.items()):
            d = first_parting(port, th[cid], want)
            if d is not None:
                parts[cid] = d
                if d[1] >= NEAR_TIE:
                    faults.append((pol, cid, *d))
        line = {"policy": pol, "layers": LAYERS,
                "conversations": args.conversations,
                "streams_equal": len(rh) - len(parts),
                "parting_at": {c: [p, g] for c, (p, g) in parts.items()},
                "swap_ops": {"reference": rops, "port": tops},
                "seconds": {"reference": rs, "port": ts}}
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"arch": ARCH, "layers": LAYERS,
               "d_model": jcfg.d_model, "head_dim": jcfg.head_dim,
               "n_heads": jcfg.n_heads, "vocab": jcfg.vocab_size,
               "near_tie": NEAR_TIE, "faults": faults,
               "streams_equal": sum(x["streams_equal"] for x in lines),
               "streams": len(lines) * args.conversations,
               "max_parting_gap": max((g for x in lines
                                       for _, g in x["parting_at"].values()),
                                      default=None),
               "init_s": init_s, "seconds": time.perf_counter() - t0}
    print(json.dumps(summary), flush=True)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
