"""Training launcher: the reference's ``python -m repro.launch.train``
with the same flags, output lines and synthetic data, and one more flag,
``--device {cuda,cpu}`` (default ``cuda``):

  * ``--device cuda`` trains the arch's published config at full width
    on the GPU from the port's seeded init (``init_params(cfg, seed,
    device)``), and exits non-zero where no GPU is there (no CPU
    fallback) or where the fp32 training state (16 B a parameter:
    parameters, gradients and two AdamW moments) exceeds the card's
    memory, before allocating (zamba2-7b: 5.7 B parameters, gemma3-12b
    12.8 B, deepseek-v2-236b 235.6 B);
  * ``--device cpu`` trains the arch's reduced config, as the
    reference's launcher does on the CPU.

Each step is ``steps.train_step`` with remat off, the reference
launcher's choice, run eagerly (no CUDA graph yet):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 200 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 3 --batch 2 --seq 32 --checkpoint /tmp/ckpt.npz
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
      --steps 5 --batch 8 --seq 128

Each step's batch is (batch, seq + 1) uniform tokens from a
``torch.Generator`` on the device seeded with ``--seed``: tokens the
first ``seq``, labels the last; an encoder-decoder (whisper) also gets
``encoder_frames`` of 0.02, as the reference's.  ``--checkpoint`` writes the final
parameters in the reference's ``.npz`` format (6.2 GB for qwen2-1.5b at
full width).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda trains the published config on the GPU; "
                         "cpu the reduced one")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import steps as S
    from repro_torch.models.transformer import count_params
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.optimizer import tree_leaves

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is "
                             "false; pass --device cpu to train the "
                             "reduced config")
        cfg = get_config(args.arch)
        # parameters, gradients and two AdamW moments, all fp32
        need = 16 * count_params(cfg)
        have = torch.cuda.get_device_properties(0).total_memory
        if need > have:
            raise SystemExit(
                f"--device cuda: {cfg.name}'s fp32 training state (16 B x "
                f"{count_params(cfg):,} parameters = {need:,} B) exceeds "
                f"the card's memory ({have:,} B); pass --device cpu to "
                "train the reduced config")
    else:
        cfg = get_smoke_config(args.arch)
    device = torch.device(args.device)
    params, opt = S.init_train_state(cfg, seed=args.seed, device=device)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n:,}")

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)

    def make_batch():
        # synthetic LM data: labels are the tokens shifted by one
        base = torch.randint(0, cfg.vocab_size, (args.batch, args.seq + 1),
                             generator=gen, device=device)
        b = {"tokens": base[:, :-1], "labels": base[:, 1:]}
        if cfg.frontend is not None and cfg.frontend.kind == "vision":
            b["extra_embeds"] = torch.full(
                (args.batch, cfg.frontend.n_tokens, cfg.frontend.d_embed),
                0.02, device=device)
        if cfg.encoder_decoder:
            b["encoder_frames"] = torch.full(
                (args.batch, cfg.n_encoder_tokens, cfg.d_model), 0.02,
                device=device)
        return b

    t0 = time.time()
    for i in range(args.steps):
        params, opt, loss = S.train_step(params, opt, make_batch(), cfg=cfg,
                                         lr=args.lr, remat=False)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {float(loss):.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)

    if args.checkpoint:
        save_checkpoint(args.checkpoint, params)
        print("saved", args.checkpoint)


if __name__ == "__main__":
    main()
