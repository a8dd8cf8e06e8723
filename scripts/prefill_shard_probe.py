#!/usr/bin/env python3
"""Where qwen2-1.5b's sharded prefill chunk first parts from the one-device
chunk on the card.

    python3 scripts/prefill_shard_probe.py [--cpu]

Builds the published qwen2-1.5b serving weights (seed 0) on the GPU, cuts
them for a (1, 2) mesh whose shards share the card, and for chunks of 256
and 352 tokens (padded to 256 and 512) compares, in layer 0, the one-device
q, k, v (after RoPE) and attention output with the shards' pieces, byte
for byte; then the whole chunk forward (last logits, carries) through
``kernels.ops.prefill_chunk`` on both paths.  Each comparison is run with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` as
PyTorch sets it and switched off.  Prints the card's name and power limit,
then one JSON line.  Needs a GPU; imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _eq(a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(a, b))


def _maxdiff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def layer0(params, shards, cfg, local, n_tokens: int) -> dict:
    """Layer 0 of a chunk from empty carries, one-device against shards."""
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import unstack_layers
    dev = params["embed"]["table"].device
    C_pad = 1 << max(4, math.ceil(math.log2(n_tokens)))
    toks = torch.tensor([[(7 * i + 3) % cfg.vocab_size
                          for i in range(n_tokens)]
                         + [0] * (C_pad - n_tokens)], device=dev)
    positions = torch.arange(C_pad, device=dev)[None, :]
    cos, sin = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    mask = (torch.arange(C_pad, device=dev)[None, :]
            <= positions[0][:, None])[None, None]
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    x = L.embed(params["embed"], toks)
    lp = unstack_layers(params["layers"])[0]
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)

    def qkv_attn(p, c):
        q, k, v = attn._project_qkv(p, h, c)
        q_raw = q
        q, k = L.rope_apply(q, cos, sin), L.rope_apply(k, cos, sin)
        return q_raw, q, k, v, attn._sdpa(q, k, v, mask, scale)

    full = qkv_attn(lp["attn"], cfg)
    parts = [qkv_attn(unstack_layers(s["layers"])[0]["attn"], local)
             for s in shards]
    names = ("q_proj", "q_rope", "k_rope", "v", "attention")
    out = {}
    for i, name in enumerate(names):
        cat = torch.cat([p[i] for p in parts], dim=2)
        out[name] = {"byte_equal": _eq(cat, full[i]),
                     "max_abs_diff": _maxdiff(cat, full[i])}
    # the shards' attention as one product over all their heads
    q = torch.cat([p[1] for p in parts], dim=2)
    k = torch.cat([p[2] for p in parts], dim=2)
    v = torch.cat([p[3] for p in parts], dim=2)
    joint = attn._sdpa(q, k, v, mask, scale)
    out["attention_joint"] = {"byte_equal": _eq(joint, full[4]),
                              "max_abs_diff": _maxdiff(joint, full[4])}
    return out


def chunk(params, shards, mesh, cfg, n_tokens: int) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.models.sharding import CARRY_HEAD_AXIS, unshard
    toks = [(7 * i + 3) % cfg.vocab_size for i in range(n_tokens)]
    one = ops.prefill_chunk(params, toks, None, None, 0, cfg=cfg,
                            block_size=16)
    sh = ops.prefill_chunk(shards, toks, None, None, 0, cfg=cfg,
                           block_size=16, mesh=mesh)
    k, v = (unshard(c, CARRY_HEAD_AXIS) for c in sh[1:3])
    diff_layers = [i for i in range(k.shape[0]) if not _eq(k[i], one[1][i])]
    return {"logit_max_abs_diff": _maxdiff(sh[0], one[0]),
            "argmax": [int(sh[0].argmax()), int(one[0].argmax())],
            "k_byte_equal": _eq(k, one[1]), "v_byte_equal": _eq(v, one[2]),
            "first_k_layer_differing": diff_layers[0] if diff_layers else None}


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    global torch
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.paged import shard_local_config
    from repro_torch.models.sharding import shard_params
    if "--cpu" in sys.argv:             # a rehearsal at the reduced config
        from repro_torch.configs import get_smoke_config
        cfg, dev, smi = get_smoke_config("qwen2-1.5b"), "cpu", "cpu"
    else:
        if not torch.cuda.is_available():
            raise SystemExit("prefill_shard_probe.py needs an NVIDIA GPU")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        cfg, dev = get_config("qwen2-1.5b"), "cuda:0"
        build.build()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    params = T.init_params(cfg, seed=0, device=dev, serving=True)
    mesh = make_serving_mesh((1, 2), [dev] * 2)
    shards = shard_params(params, mesh)
    local = shard_local_config(cfg, 2)
    result = {"nvidia_smi": smi, "torch": torch.__version__}
    default = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    for rpr in (default, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = rpr
        key = f"bf16_reduced_precision_reduction={rpr}"
        result[key] = {n: {"layer0": layer0(params, shards, cfg, local, n),
                           "chunk": chunk(params, shards, mesh, cfg, n)}
                       for n in (256, 352)}
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = default
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
