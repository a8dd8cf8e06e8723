#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # and a profiled engine run

Phases, each printing one JSON line (``{"phase": ...}``):

  1. device  — the card's name and power limit (``nvidia-smi``); fails
               when ``torch.cuda.is_available()`` is false.
  2. build   — ``nvcc`` on every ``src/repro_torch/csrc/*.cu``, one process
               per source, all started together beside phase 1's CUDA
               start-up; seconds and the ``-Xptxas -v`` register /
               shared-memory lines.
  3. kernels — each kernel's wrapper against its plain PyTorch version on
               the card, and CUDA-event times of the kernel, the plain
               version and one PyTorch library call computing the same
               function (where one exists).  Shapes: qwen2-1.5b's decode
               attention (B 8 and 32 over tables of 64 and 128 pages, and
               the engine's bucket, B 8 x 64 pages with contexts 256-600,
               also at olmoe-1b-7b's 16 / 16 heads, a GQA group of 1;
               timed at B 32 x 128 pages and at the engine's bucket, both
               groups), the kernels' domain past D 128 (B 32 x 128 pages
               at D 64 in bf16 and in fp32, at D 256, and at Hq 32 / Hkv
               2, a group of 16, at D 128; each timed, fp32 within 1e-5)
               and one 64-block swap chunk (gather, scatter, and
               the same chunk as per-block pairs and as grouped 2-D runs:
               byte-equal; gather and scatter also over olmoe-1b-7b's
               pool, 32 planes of 64 KiB rows); its prefill attention,
               B 1 x T 2048 and
               B 8 x T 512 (flash, every element within a bf16 tolerance);
               zamba2-7b's SSD scan, 112 heads x T 4096 (y and S within
               stated bounds).
  3b. ops    — the kernels with no serving-path caller, driven once each
               through the public API ``repro_torch.kernels.ops`` at those
               widths, with their launch counts set to 0 just before and
               read just after (the scan's model path is phase 5i).
  3c. swap   — one 64-block swap (phase 3's chunk, three runs) out of a
               ``PagedPools`` and back in, at qwen2-1.5b's pool layout (448
               KiB blocks) and olmoe-1b-7b's (2 MiB), three ways: per block
               (64 ``copy_out([g], [c])``, then 64 ``copy_in``), one
               ``copy_out`` / ``copy_in`` call, and ``copy_out_staged`` /
               ``copy_in_staged``; three runs each, every way's host and
               device blocks byte-equal to the pool before; host ms and
               GB/s of each leg beside the host link's rate (one pinned
               ``copy_`` of the same bytes each way).
  4. engine  — qwen2-1.5b at full width (random weights from a seed) served
               by ``ServingEngine`` in real mode with the fastswitch policy
               and a KV pool small enough to force preemption; every turn
               must finish, every conversation swapped out and back in, no
               swap copy retried or failed, every kernel launched, and
               paged attention once per layer per decode step.  Both runs
               hold swap tasks to the simulated clock: they make 81
               swap-outs and 156 swap-in sub-slabs, and the timed run's
               tokens equal the warm-up's.  Each
               decode step after a bucket's first replays the bucket's
               captured CUDA graph (``graphs_captured``, ``graph_replays``,
               ``eager_steps``).  Wall seconds and tokens/s are measured;
               TTFT/TBT are the engine's simulated clock, modelled by the
               A10 cost model, and named so.
  5. e2e     — every conversation's greedy tokens against a plain dense
               forward (no pages, plain attention) on the card.
  5a. oracle — every conversation replayed straight through the exact-shape
               data plane on the card (``prefill_kv`` of the history,
               ``PagedPools.write_tokens``, then ``paged_decode_step`` at
               batch 1 per token): the engine's greedy tokens equal the
               oracle's, or first differ at a near-tie of the oracle's
               logits (0.05).
  5b. sampling — a full-width ``ServingEngine`` serving eight requests in
               one batch, the odd ones at ``SamplingParams(temperature=0.8,
               top_k=50, top_p=0.9)``, the even ones greedy: greedy tokens
               as in ``e2e``; every sampled token the CPU's plain sampler
               draws from the dense forward's logits with the row's key
               (or a stated near-tie); a second identical run gives the
               same tokens, with paged attention counted once per layer
               per step (counts set to 0 just before it); the greedy
               requests' tokens equal those of an all-greedy batch; the
               threefry words made on the card equal the CPU's byte for
               byte; one replay of each variant is timed.
  5c. graphs — in the first (warm-up) engine run and the first sampling
               run, the first replay of every (bucket, variant) the engine
               steps (argmax-only, and sampled) is held against an eager
               step over clones of the same state: next tokens, pool,
               context lengths and last tokens equal byte for byte.
  5d. serve  — the launcher, ``python -m repro_torch.launch.serve``, as a
               subprocess at full width: a real-mode replay of qwen2-1.5b
               under both policies (vllm and fastswitch, 8 conversations;
               per-policy summary, swaps, ``callstack_wall_s`` and its
               kernel launches) and the online smoke with its event log
               passed through ``validate_event_log`` (run beside phases 5
               and 5a, which time nothing); a non-zero exit fails the
               script.
  5e. frontend — ``FrontendServer`` over two full-width real replicas on
               the card (one parameter bundle, a pool each: 64 GPU and 256
               CPU blocks, max 4 running, max batch 4, fastswitch) on
               127.0.0.1, port 0: the loopback smoke's clients (submit,
               stream, follow-up, abort) with token-id prompts, two
               sessions moved between the replicas with their shipped KV
               held byte for byte against what the target installed, then
               a drain; every replica's event log well-formed, no affinity
               violation, every streamed token the dense argmax or a
               near-tie, and paged attention and both run copies launched
               on each replica's pool (counts set to 0 just before; per
               replica, and their sum).  Then the launcher's ``--serve
               --router 2 --real`` as a subprocess: one session finishes,
               and an interrupt stops it with exit code 0.
  5f. prefix — the launcher's ``--online --real --prefix-cache --smoke``
               (prefix hits, tokens saved, the C1/C2 sanitizer on every
               step, a well-formed event log, its kernels launched) and,
               at the same time, the same smoke with the cache off: each
               conversation's greedy tokens equal, or the first
               difference a near-tie.
  5m. control — in process right after 5f, on the engine phase's
               bundle, workload and pool (160 GPU / 1024 CPU blocks), with
               the serving kernels' launch counts set to 0 just before
               (each must launch): the workload through an open-world
               client under ``FaultPlan.chaos(seed=0, intensity=1.0)``
               with the sanitizer after every step and the copy watchdog
               on (at least three fault kinds fire, ``step()`` never
               raises, every request ends as length, stop, error or shed,
               every block, swap task and runner row reclaimed, the event
               log well-formed, every turn finished by length the dense
               argmax or a near-tie); a poisoned request beside a
               survivor, a permanent swap-out fault resumed by recompute,
               and stalled copies the watchdog forces through, each held
               against a fault-free run (equal, or first different at a
               near-tie); one request aborted in each lifecycle state
               (waiting, mid chunked prefill, running, swapped, swapping in
               with its staged chunk tasks in flight, recompute waiting,
               finished and retained) beside a survivor so held, each abort
               followed by the sanitizer, its runner row back on the trash
               sentinel and no leak once drained, and after the swapping-in
               abort a new request decoding the dense argmax; a stop token
               mid-stream ending the turn as stop, its tokens byte-equal
               to the stop-free run's through the stop token.
  5r. reduced — right after 5m, in this process (alone:
               ``scripts/reduced_probe.py``): the reference's real-mode
               models, the reduced configs of the five archs the paged
               path serves (qwen2-1.5b, olmoe-1b-7b, llama3.2-3b,
               mistral-nemo-12b, llava-next-mistral-7b: d_model 256, 2
               layers, 4 query heads of 64 over 2 KV heads, olmoe 4 / 4
               with 4 experts), bf16 serving weights drawn once from seed
               0 on the CPU and copied to the card, on the engine phase's
               workload and pool under vllm and fastswitch: each run on
               the card (a fresh engine, swap tasks held to the simulated
               clock, every staged swap byte for byte) against the same
               run on the host's CPU (worker processes beside the card
               runs): swap ops and blocks each way equal, every stream
               equal or first parting at a token whose CPU engine call
               had a top-2 logit gap under NEAR_TIE (or, in olmoe, a
               routing gap under ROUTE_TIE), paged attention launched (at
               head_dim 64) on every card run.  Then the launcher's
               ``--online --smoke --real --device cuda --reduced --arch
               qwen2-1.5b``, the reference's tier-1 real smoke on the
               card: exit 0 with its drain and token assertions, paged
               attention launched.
  5n. reuse  — right after 5r, in a process of its own
               (``scripts/reuse_probe.py``): qwen2-1.5b at full width
               (random fp32 weights from seed 0, as the engine phase) on
               the engine phase's workload with 160 GPU blocks and a host
               pool of 256, then 192, blocks (117 and 88 MB), the serving
               kernels' launch counts set to 0 before each run: KV reuse's
               copies are contaminated, and some requests are swapped back in
               over a copy valid for fewer positions than hold their KV.
               Each run must finish every turn, restore no block past a
               copy's valid prefix (``watch_swap_ins``), resume at least
               one short copy by restoring its valid prefix and
               recomputing the rest (``short_copy_resumes``), serve every
               greedy token as the dense argmax or a near-tie, and launch
               each serving kernel; per size the contaminations, swap-ins
               and those over a short copy, the restored and recomputed
               tokens, the wall.  The engine phase's 1024-block pool must
               resume none.
  5p. ladder — right after 5n, in a process of its own
               (``scripts/ladder_probe.py``): the paper's four-policy
               ladder (vllm, +dbg, +dbg+reuse, fastswitch) with
               mistral-nemo-12b at full width (40 layers, d_model 5120,
               32 / 8 heads of 128, d_ff 14336, vocab 131072; random bf16
               serving weights from seed 0, one init) on the engine
               phase's workload and pool (2.5 MiB blocks: 400 MiB of
               device pool, 2.5 GiB of pinned host pool), each policy a
               fresh engine on the one bundle, swap tasks held to the
               simulated clock: a watched run whose every staged swap
               is held byte for byte (``watch_moved_kv``; the first also
               pays the process's one-time costs), then the timed run,
               whose tokens must equal the watched run's.  Each run
               finishes every turn, swaps both ways, retries and fails no
               copy, leaks no block or runner row (``check_reclaimed``)
               and launches paged attention, gather and scatter.  Every
               greedy token is the argmax of the dense forward in fp32
               of the bf16 weights (``full_precision``) or within
               max(NEAR_TIE, the largest logit distance of the bf16 and
               fp32 dense forwards, the spread measured in the same
               run), at least ``LADDER_NEAR_TIE_SHARE`` (97.5 %) of each
               policy's tokens are within NEAR_TIE, and every two
               policies' streams are equal or first part within the
               tolerance.  Per policy: wall, host
               seconds by method, swap
               operations and blocks each way, ``fenced_swap_ins``,
               launches; the device's idle share in a window of one more
               fastswitch run, iterations 40-54 under the profiler
               (``PROFILE_WINDOW``).
  5g. moe    — olmoe-1b-7b at full width (16 layers, d_model 2048, 16 / 16
               heads of 128, 64 experts top-8, random weights from a seed,
               bf16 serving copy only) through the engine phase's workload:
               a warm-up run (each bucket's first replay byte-equal to its
               eager step), then a timed run (launch counts set to 0 just
               before) whose tokens must equal the warm-up's, both with
               swap tasks held to the simulated clock, then one unheld
               run; every turn finished, no copy retried or failed, every
               conversation swapped out and back in; at the engine's
               bucket one decode step with the CUDA paged attention
               against the same step with its plain version, routed alike
               (``moe_oracle``); one replay's ms beside the step's bound
               (the routed experts' weights and walked KV over HBM) and
               its dense-dispatch bound; peak memory; the held runs make
               74 swap-outs and 142 swap-in sub-slabs.  Beside such
               replays, back to back, a staged swap-in of 64 blocks at
               olmoe's layout from a worker thread, under
               ``torch.profiler``: the time its copies and scatters
               overlap the replays' kernels, whether each sub-slab's
               upload starts before the previous one's scatter ends, and
               its completion beside a replay alone and the swap alone
               (``overlap_probe``).  Then the
               launcher's ``--real --arch olmoe-1b-7b --conversations 2``
               as a subprocess.  The phase runs in a process of its own,
               ``scripts/moe_probe.py`` (``--profile`` there adds the
               replay's kernels by device time).
  5h. train  — qwen2-1.5b at full width trained through
               ``models/steps.py`` (fp32 parameters, AdamW, eager; no
               kernel is on this path): 8 ``train_step``s with remat on
               over one batch of B 8 x T 128, every loss finite and the
               last below the first; one state's loss and gradients with
               remat on and off (equal losses, gradients within
               ``REMAT_GRAD_RTOL``, byte equality reported); the config cut
               to 2 layers on the card against the CPU, the same params
               and a batch of B 2 x T 64 (the loss and every gradient
               leaf within stated bounds); greedy decode of 8 prompts of
               256 tokens through ``prefill``, ``caches_from_prefill`` (512
               positions) and 32 ``serve_step``s, every token the dense
               forward's argmax or a near-tie, and the same with an int8
               cache (finite; its agreement reported); the step's median
               ms, tokens/s, model FLOPs and their share of the bf16 peak,
               CUDA-event ms of ``loss_and_grads``, ``adamw_update`` and
               the CE product, one step under ``torch.profiler`` (device
               busy ms, idle share, host waits for the card), peak memory
               with remat on and off; then the
               launcher, ``python -m repro_torch.launch.train --arch
               qwen2-1.5b --steps 5 --batch 8 --seq 128``, as a subprocess.
               In a process of its own, ``scripts/train_probe.py``.
  5i. ssm    — the SSM and hybrid families, in a process of its own
               (``scripts/ssm_probe.py``).  zamba2-7b at full width cut
               in depth (``SSM_DEPTH``: 9 of its 81 layers, one period
               of 5 Mamba2 layers and the shared attention block, then
               its 3 remainder Mamba2 layers; d_model 3584, 112 SSD
               heads, N = P = chunk = 64; random weights from a seed,
               bf16 serving copy only): a prefill of 8 prompts of 256
               through ``steps.prefill``, the SSD scan kernel's launch
               count set to 0 just before and read just after (8: once
               per Mamba2 layer); the same
               prefill with the kernel's plain version (last logits
               within twice the distance of two plain prefills whose scans
               differ in summation order, ``SSM_SPREAD_FACTOR``; the first
               layer's scan within phase 3's bounds);
               ``caches_from_prefill`` (512 positions) and 32 greedy
               ``serve_step``s, every token the dense forward's argmax or
               a near-tie (within twice two plain dense forwards'
               distance); prefill and decode-step ms,
               a decode step under ``torch.profiler`` (its launches), its
               weight-traffic bound, the scan's ms at the prefill's shape,
               peak memory.  Its train step cut to one period (6 layers)
               at full width, B 2 x T 64, against the CPU (loss and every
               gradient leaf within stated bounds; no scan launched: no
               kernel has a backward).  rwkv6-1.6b at full width cut to 4
               of its 24 layers through ``train_phase`` (8 steps with
               remat on over one batch of B
               8 x T 128, remat on against off, the card against the CPU
               at 2 layers, greedy decode of 8 prompts of 256 over 32
               steps, step ms, tokens/s, FLOP share, peak memory, then
               ``launch.train --arch rwkv6-1.6b --steps 5 --batch 8 --seq
               128``, the whole model).  Then the launchers' refusals of
               zamba2-7b:
               ``launch.train --device cuda`` (its 92 GB fp32 training
               state exceeds the card) and ``launch.serve --real`` (no
               paged path, the reference's message), both non-zero.
  5j. families — the last three families, in a process of its own
               (``scripts/families_probe.py``); no kernel is on their
               path (plain torch attention, as the reference's XLA).
               gemma3-12b at full width cut to 6 of its 48 layers (one
               period of 5 local : 1 global, window 1024;
               ``FAMILIES_DEPTH``) from a bf16 serving init: prefills
               of 4 x 1500 and 1 x 5000 tokens (``_sdpa_chunked``), 32
               greedy decode steps each past the local rings' wrap, the
               rings' slots against the sequence K (``ring_check``), every
               token the dense forward's argmax or a near-tie; times, a
               profiled step, its bytes bound, peak memory.  Its train
               step cut to one period (6 layers) for 8 steps; its smoke
               config's gradients on the card against the CPU's.
               deepseek-v2-236b cut to 2 layers (MLA, a dense layer 0,
               one MoE layer of 160 experts): a prefill of 4 x 512 and 32
               absorbed-weight decode steps; layer 0's decode against its
               sequence forward (``MLA_LAYER_RTOL``); each token counted
               as equal, a logit or a routing near-tie, or a prefill
               capacity drop, against a dropless dense forward; its smoke
               config's gradients against the CPU's.  whisper-large-v3 at
               full width cut to 4 + 4 of its 32 + 32 layers through
               ``train_phase`` (B 8 x T 128 with encoder frames, 2 + 2
               layers against the CPU, a decode of 8 x 64, its launcher
               on the whole model).  The launchers' refusals:
               ``launch.train
               --device cuda`` of gemma3-12b and deepseek-v2-236b,
               ``launch.serve --real`` of all three.
  5k. mesh   — tensor-parallel serving, in a process of its own
               (``scripts/mesh_probe.py``): the engine phase's workload
               served by qwen2-1.5b whole on a (1, 2) mesh (6 / 1 heads a
               shard) and by olmoe-1b-7b whole from its bf16 serving init
               on a (1, 4) mesh (4 / 4 heads a shard), every shard on this
               card (an explicit device list with repeats), each beside the
               same workload on one device.  Per mesh: a warm-up (each
               bucket's first replay byte-equal to its eager step) and a
               timed run with the serving kernels' counts set to 0 just
               before, both held to the simulated clock: the held swap
               counts (81 / 156 and 74 / 142, as on one device); one d2h
               per staged swap-out and one h2d per swap-in sub-slab per
               shard; every turn finished, every conversation swapped both
               ways, no copy retried or failed; paged attention once per
               layer per shard per step, each shard's run copies once per
               staged chunk; the one-device run's graph counts; the two
               runs' tokens equal; qwen2's tokens equal to the one-device
               run's or the dense argmax or a near-tie (0.05); the oracle
               step at the engine's bucket, the sharded step against the
               one-device step on the same state (olmoe's routing pinned;
               every logit within 0.1, the argmax equal or a near-tie);
               the engine bucket's attention per shard against its plain
               version (phase 3's bound), the shards' outputs against the
               one-device launch; one 64-block staged swap out of and back
               into a one-device pool and a mesh pool holding the same
               bytes (host and device blocks byte-equal); wall, host
               seconds by method, per-shard launches, transfers, peak
               memory.  On (1, 2), the sampling phase's batch (the sampled
               variant's first replay held to eager; every token the plain
               sampler's draw or a near-tie).  Then the engine's refusals
               of a mesh over two CUDA devices (``NotImplementedError``)
               and of a default device list too short (``ValueError``),
               before any work.
  5l. examples — the examples, in a process of its own
               (``scripts/examples_probe.py``): ``examples/
               torch_quickstart.py``'s engine built in process
               (``build("cuda")``: llama3.2-3b at full width, 28 layers,
               d_model 3072, 24 / 8 heads of 128, random bf16 weights from
               seed 0) and run — every turn finished, preemption, swaps
               both ways, no copy retried or failed, greedy tokens the
               dense argmax or a near-tie (0.05), paged attention, gather
               and scatter each launched (counted at every replay), wall
               and host seconds by method; then ``python
               examples/torch_quickstart.py`` (exit 0, its ``served`` and
               ``preemptions`` lines read) and ``python
               examples/torch_train_lm.py --steps 50`` (exit 0, the loss
               falls, the checkpoint round-trips byte for byte).
  5o. dev    — the dev scripts as three subprocesses at once on the card:
               ``scripts/torch_dev_kernels.py`` (paged attention in the
               reference's own case, fp32 at head_dim 64, per-block and
               grouped copies at ``scripts/dev_kernels.py``'s sizes, each
               against its plain version: copies byte-equal, paged
               attention within 1e-5; their launches),
               ``torch_dev_engine.py 20`` (sim mode, four policies, the
               same tokens each) and ``torch_dev_smoke.py`` (the ten smoke
               archs' forward, train step, prefill and 3 decode steps).
  5q. fairness_example — ``examples/torch_fairness_comparison.py`` (the
               ladder in sim mode on the paper's LLaMA-8B/A10 scenario, CPU
               only), started in the background at a lower priority after
               phase 2 and read after 5o: exit 0, and one well-formed line
               per policy of the ladder, in order.
  6. device_times — the device time of each phase-3 kernel and library
               call alone: their CUDA kernels under ``torch.profiler``, the
               wrapper's host time left out.  After the engine phases,
               since a profiler session leaves the CUDA activity tracing
               (CUPTI) attached, which adds host time to every later
               launch.  A session that comes back without its device
               events is made again, up to three times
               (``profiler_sessions_made_again``); where all three came
               back empty (seen late in this process on an H100 while
               younger processes' sessions held their events; cause not
               found), the time is the CUDA events' around each call
               queued behind a sleep kernel (``queued_ms``), which is
               also taken for every call beside the profiler's
               (``events``, ``device_ms_by``).
  (profile)  — with ``--profile`` only: one more engine run under
               ``torch.profiler``; the device's idle share of its wall time,
               its operations by device time, and the paged-attention
               kernels' (split and combine) launches and device time; the
               profiler's count of each must equal the wrapper's count,
               replays included.

  7. dryrun  — the dry-run and roofline tools: ``python -m
               repro_torch.launch.dryrun --all`` (every arch x shape on
               the 16 x 16 mesh, traced over DTensors on a fake process
               group; the 2 x 16 x 16 mesh's train cases trace for minutes
               each, so it is left to the CLI; CPU only, started in
               the background after phase 2 in ``DRYRUN_JOBS`` processes at
               a lower priority; its seconds taken when it exits, and the
               seconds phase 7 waited for it): ok, skipped (the long_500k
               rule only) and failed cases counted, none may fail;
               ``--serving`` at full
               width on the card (three requests, one aborted: its tokens,
               decode-graph variants and kernel launches); ``--audit-jit``
               on qwen2-1.5b at full width (exit 0: fslint's static FS002
               degrees for all five rows, and the live counts of the
               decode step's graphs and of the swap, insert and chunk
               sites' padded shape keys within their bounds; the two CLI
               runs at once); and on a (1, 1)
               host mesh, qwen2-1.5b's train step (B 8 x T 128) and its
               contiguous-cache decode step (B 8 against 128 positions):
               the dry-run's argument bytes equal to the real steps'
               tensors' bytes, its roofline floor (max of the compute and
               memory terms) at most the measured step, and the peak
               allocated beside arguments plus the temp estimate.

Then a ``kernels`` line (per kernel: launches on its path, error, times
around the call and on the device, bound, and the bound's share of the
device time; the serving kernels' launches on each path beside the
engine's, the mesh runs' summed over their shards and per shard; the
scan's launches are those of phase 5i's zamba2 prefill, with its times
there beside phase 3's) and, as the last line,
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
then not 0 and the last line is not printed.  Imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "qwen2-1.5b"
SEED = 0
# bf16 outputs of a softmax-weighted mean of O(1) values: both sides round
# once to bf16 after fp32 sums in other orders, so an element may differ by
# one bf16 ulp (at most 2^-7 relative); the absolute floor covers outputs
# near 0.  Rows of ~2000 tokens average to ~0.05, so a dropped or doubled
# 64-token tile (a change of several percent there) fails.  Held per
# element as |out - ref| <= ATTN_ATOL + ATTN_RTOL * |ref|.
ATTN_ATOL, ATTN_RTOL = 1e-3, 2 ** -7
# fp32 outputs (the fp32 kernel): exact fp32 products summed in other
# orders, as tests/test_kernels.py holds the reference's fp32 sweep
ATTN_F32_TOL = 1e-5
# the SSD scan's bf16 y: one bf16 ulp as above (ATTN_RTOL) over fp32 sums
# in other orders, with a floor for values near 0 (measured on an H100 at
# zamba2-7b's shapes: max abs error 0.03125, one ulp at |y| in [4, 8)); its
# fp32 state S: the sums' rounding only (measured max abs error 3.5e-6;
# the bound is ~6x that)
GLA_Y_ATOL = 1e-4
GLA_S_ATOL, GLA_S_RTOL = 2e-5, 1e-5
# a greedy token the dense forward disagrees with is accepted only where
# the dense forward's logit for it is this close to its own maximum: bf16
# activations through 28 layers round at other places in the paged path
# (chunked prefill, the hand-written attention kernel) than in the dense
# one, which can flip a near-tie but not a clear winner
NEAR_TIE = 5e-2
# the sampling phase's sampled requests; a sampled token the CPU's plain
# sampler does not draw from the dense forward's logits is accepted only
# where the two tokens' scaled logits plus Gumbel noise lie within
# NEAR_TIE / temperature (the greedy rule, scaled as the sampler scales
# the logits), where either token's scaled logit lies that close to the
# top-k threshold, or where the nucleus mass before either token lies
# within NUCLEUS_EPS of top_p (probabilities moved by such logit
# differences, summed over the tokens ranked above)
SAMPLING = (0.8, 50, 0.9)
NUCLEUS_EPS = 2e-2
# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# dense bf16 tensor-core FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Mean CUDA-event time of ``fn`` in ms; ``flush`` (a tensor larger
    than the L2 cache) is overwritten before each timed launch, so every
    launch starts cold, as a decode step finds a layer's KV."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def queued_ms(fn, iters: int = 20, warmup: int = 3, flush=None,
              sleep_cycles: int = 2 ** 27, tries: int = 3) -> float:
    """Mean device time of ``fn`` in ms from CUDA events alone: every call
    (each after ``time_ms``'s L2 flush) is queued behind a sleep kernel,
    so the card runs them back to back and the events around each call
    time its kernels without the host's launch time.  Holds only where
    the last call was queued before the sleep ended; otherwise the sleep
    is doubled and the calls made again, and after ``tries`` an error is
    raised.  The profiler-free reading of ``device_ms``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        asleep = torch.cuda.Event()
        torch.cuda._sleep(sleep_cycles)
        asleep.record()
        for start, end in marks:
            if flush is not None:
                flush.zero_()
            start.record()
            fn()
            end.record()
        queued = not asleep.query()
        torch.cuda.synchronize()
        if queued:
            return sum(s.elapsed_time(e) for s, e in marks) / iters
        sleep_cycles *= 2
    raise AssertionError(f"the card ran the calls before the last was "
                         f"queued, {tries} times, the last behind "
                         f"{sleep_cycles // 2} cycles of sleep")


def kernel_ms(events, iters: int, skip=frozenset(),
              skipped_per_call=None) -> float:
    """Mean device ms per call from profiler device events (objects with
    ``name`` and ``time_range.start`` / ``.end`` in µs): the summed
    durations of every event not named in ``skip``, over ``iters`` calls.
    Every call launches the same kernels, so raises where no event is
    left or their count is not a multiple of ``iters`` (events lost or
    from elsewhere), and, given ``skipped_per_call``, where the events
    named in ``skip`` are not that many per call (a flush's kernel lost,
    which could leave a count that still divides)."""
    us = [e.time_range.end - e.time_range.start for e in events
          if e.name not in skip]
    n_skipped = len(events) - len(us)
    if not us or len(us) % iters:
        raise AssertionError(f"the profiler recorded {len(us)} device "
                             f"kernels for {iters} calls")
    if skipped_per_call is not None and \
            n_skipped != skipped_per_call * iters:
        raise AssertionError(f"the profiler recorded {n_skipped} flush "
                             f"kernels for {iters} calls, not "
                             f"{skipped_per_call} each")
    return sum(us) / 1e3 / iters


def _device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def remeasured(measure, tries: int = 3):
    """``measure()``'s first result over at most ``tries`` calls: a call
    that raises ``AssertionError`` (a profiler session that came back
    without its device events) is reported on stderr and made again; the
    last such error is raised when every call failed.  Counts the calls
    made again in ``remeasured.retries``."""
    for attempt in range(1, tries + 1):
        try:
            return measure()
        except AssertionError as fault:
            print(f"device time, attempt {attempt} of {tries}: {fault}",
                  file=sys.stderr, flush=True)
            if attempt == tries:
                raise
            remeasured.retries += 1


remeasured.retries = 0


def device_ms(fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Mean device time of ``fn`` in ms: its CUDA kernels' durations under
    ``torch.profiler`` over ``iters`` calls, each after the L2 flush of
    ``time_ms`` (whose own kernels, found in a first profiled flush, are
    left out), so the wrapper's host time is not counted.  The profiler
    now and then returns a session with no device event (seen once on an
    H100 in twenty-odd runs); both sessions are then made again
    (``remeasured``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(warmup):
        fn()

    def measure():
        skip, flushed = set(), []
        if flush is not None:
            with profile(activities=acts) as prof:
                flush.zero_()
                torch.cuda.synchronize()
            flushed = _device_events(prof)
            # with no flush kernel to leave out, the flushes would be
            # counted as the call's own kernels
            if not flushed:
                raise AssertionError("the profiler recorded no device "
                                     "kernel for the L2 flush")
            skip = {e.name for e in flushed}
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        return kernel_ms(_device_events(prof), iters, skip,
                         len(flushed) if flush is not None else None)
    return remeasured(measure)


def timings(kernel, plain, library, flush) -> dict:
    """CUDA-event means around three callables (``library`` may be None):
    ``ms``, ``plain_ms``, ``library_ms``; ``fns`` keeps the kernel and the
    library call for ``add_device_times``."""
    return {"ms": time_ms(kernel, flush=flush),
            "plain_ms": time_ms(plain, iters=5, flush=flush),
            "library_ms": (None if library is None
                           else time_ms(library, flush=flush)),
            "fns": (kernel, library)}


def add_device_times(timed: dict, flush) -> None:
    """``device_ms`` and ``library_device_ms`` of a ``timings`` result,
    from its kept callables (which it then drops): the profiler's
    reading (``device_ms``), or, where its sessions came back without
    their device events every time, the CUDA events' (``queued_ms``),
    which is also kept beside it as ``events_ms`` and
    ``library_events_ms``; ``device_ms_by`` and ``library_device_ms_by``
    name the reading used."""
    kernel, library = timed.pop("fns")
    for key, fn in (("", kernel), ("library_", library)):
        if fn is None:
            timed.update({f"{key}device_ms": None, f"{key}events_ms": None,
                          f"{key}device_ms_by": None})
            continue
        timed[f"{key}events_ms"] = queued_ms(fn, flush=flush)
        try:
            timed[f"{key}device_ms"] = device_ms(fn, flush=flush)
            timed[f"{key}device_ms_by"] = "profiler"
        except AssertionError as fault:
            print(f"device time from CUDA events instead: {fault}",
                  file=sys.stderr, flush=True)
            timed[f"{key}device_ms"] = timed[f"{key}events_ms"]
            timed[f"{key}device_ms_by"] = "cuda_events"


def bound_ms(nbytes: float, flops: float):
    """(least time in ms, what bounds it) on the published peaks."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / BF16_FLOPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def attention_case(B: int, n_pages: int, device, seed: int, Hq=12, Hkv=2,
                   D=128, bs=16, ctx_range=None, dtype=None):
    """Paged-attention inputs at qwen2-1.5b's head shape (bf16 unless
    ``dtype``): contexts spread over 1..n_pages*bs, row 0 with ctx 0 (the
    uniform mean of V) and the last row a freed decode row (trash page,
    ctx 1); or, given ``ctx_range`` (lo, hi), contexts spread evenly over
    it and no such rows, as the engine's decode batch holds them."""
    import numpy as np
    import torch
    dtype = dtype or torch.bfloat16
    rng = np.random.default_rng(seed)
    nb = B * n_pages + 2
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, Hq, D), generator=g, device=device).to(dtype)
    k = torch.randn((nb, bs, Hkv, D), generator=g, device=device).to(dtype)
    v = torch.randn((nb, bs, Hkv, D), generator=g, device=device).to(dtype)
    bt = rng.permutation(nb - 1)[:B * n_pages].reshape(B, n_pages)
    if ctx_range is not None:
        ctx = np.linspace(*ctx_range, B).astype(np.int64)
    else:
        ctx = np.linspace(1, n_pages * bs, B).astype(np.int64)
        ctx[0] = 0
        bt[B - 1] = nb - 1
        ctx[B - 1] = 1
    return dict(q=q, k=k, v=v, scale=D ** -0.5,
                bt=torch.from_numpy(bt.astype(np.int32)).to(device),
                ctx=torch.from_numpy(ctx.astype(np.int32)).to(device),
                ppcb=4, bs=bs, n_pages=n_pages)


def attention_work(case):
    """(bytes, flops) the decode attention needs for these inputs: each
    row's walked K and V once, q and the output once, its table row."""
    B, Hq, D = case["q"].shape
    _, bs, Hkv, _ = case["k"].shape
    npad = -(-case["n_pages"] // case["ppcb"]) * case["ppcb"]
    tokens = [c if c > 0 else npad * bs for c in case["ctx"].tolist()]
    walked = sum(min(t, npad * bs) for t in tokens)
    size = case["q"].element_size()
    nbytes = (walked * Hkv * D * size * 2 + 2 * B * Hq * D * size
              + case["bt"].numel() * 4 + B * 4)
    flops = 4 * walked * Hq * D               # QK^T and PV, 2 per MAC
    return nbytes, flops


def attention_error(out, ref, what: str = "paged_attention") -> float:
    """Max abs error of ``out`` against ``ref``; raises where an element
    is off by more than ATTN_ATOL + ATTN_RTOL * |ref| (bf16), or
    ATTN_F32_TOL * (1 + |ref|) (fp32)."""
    import torch
    atol, rtol = ((ATTN_F32_TOL, ATTN_F32_TOL) if out.dtype == torch.float32
                  else (ATTN_ATOL, ATTN_RTOL))
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    excess = float((diff - rtol * ref.abs()).max())
    err = float(diff.max())
    if not (math.isfinite(err) and excess <= atol):
        raise AssertionError(f"{what}: max abs error {err}, an "
                             f"element {excess} above {rtol} * |ref| "
                             f"(allowed {atol})")
    return err


def check_attention(case) -> float:
    """Max abs error of the kernel against the plain version."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    args = (case["q"], case["k"], case["v"], case["bt"], case["ctx"],
            case["scale"], case["ppcb"])
    out = pa.paged_attention(*args)
    ref = pa.paged_attention_plain(*args)
    torch.cuda.synchronize()
    return attention_error(out, ref)


def time_attention(case, flush):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    args = (case["q"], case["k"], case["v"], case["bt"], case["ctx"],
            case["scale"], case["ppcb"])
    # yardstick only: SDPA over the table's K/V gathered beforehand
    B, Hq, D = case["q"].shape
    _, bs, Hkv, _ = case["k"].shape
    S = case["n_pages"] * bs
    bt = case["bt"].long()
    kg = case["k"][bt].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    vg = case["v"][bt].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=bt.device)[None, :]
            < case["ctx"].long()[:, None])[:, None, None, :]
    q4 = case["q"][:, :, None, :]
    return timings(lambda: pa.paged_attention(*args),
                   lambda: pa.paged_attention_plain(*args),
                   lambda: F.scaled_dot_product_attention(
                       q4, kg, vg, attn_mask=mask, scale=case["scale"],
                       enable_gqa=True), flush)


def copy_case(device, seed: int, nb=512, runs=((3, 20), (40, 12), (100, 32)),
              L=28, bs=16, Hkv=2, D=128):
    """A 64-block swap chunk in three runs over a pool of C = L * 2
    planes of E = bs * Hkv * D bf16 rows: by default qwen2-1.5b's, 56
    planes of 4096 (8 KB) rows; olmoe-1b-7b's (L 16, Hkv 16) is 32 planes
    of 32768 (64 KiB) rows."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    pool = torch.randint(-2 ** 15, 2 ** 15, (L, 2, nb, bs, Hkv, D),
                         generator=g, dtype=torch.int16, device=device)
    return dict(pool=pool.view(torch.bfloat16), runs=list(runs))


def check_copies(case):
    """Gather and scatter through the kernels and the plain version:
    byte-equal, and the scatter leaves unnamed blocks alone.  Returns the
    gathered slab and the scatter's destination runs."""
    import torch
    from repro_torch.kernels import block_copy as bc
    from repro_torch.kernels import ops
    pool, runs = case["pool"], case["runs"]
    slab, total = ops.gather_swap_runs(pool, runs)
    src, dst, lens, _, _, rb = ops._pad_runs(runs)
    L, K, nb, bs, H, D = pool.shape
    p5 = pool.view(L * K, nb, bs, H, D)
    dev = pool.device
    ref = torch.zeros_like(slab)
    bc.copy_runs_plain(p5, ref, torch.from_numpy(src).to(dev),
                       torch.from_numpy(dst).to(dev),
                       torch.from_numpy(lens).to(dev), rb)
    if not torch.equal(slab.view(torch.int16), ref.view(torch.int16)):
        raise AssertionError("block_gather_runs: slab differs from plain")
    dst_runs, off = [], 7                 # other, disjoint places
    for _, n in runs:
        dst_runs.append((off, n))
        off += n + 5
    pool2 = torch.zeros_like(pool)
    ops.scatter_swap_runs(pool2, slab, dst_runs)
    s2, d2, l2, _, _, rb2 = ops._pad_runs(dst_runs)
    ref2 = torch.zeros_like(pool).view(L * K, nb, bs, H, D)
    bc.copy_runs_plain(slab, ref2, torch.from_numpy(d2).to(dev),
                       torch.from_numpy(s2).to(dev),
                       torch.from_numpy(l2).to(dev), rb2)
    torch.cuda.synchronize()
    if not torch.equal(pool2.view(torch.int16),
                       ref2.view(pool.shape).view(torch.int16)):
        raise AssertionError("block_scatter_runs: pool differs from plain")
    if total != sum(n for _, n in runs):
        raise AssertionError(f"block_gather_runs: {total} blocks gathered")
    return slab, dst_runs


def time_copies(case, dst_runs, flush):
    """``timings`` of both directions: kernel, plain version, and one
    PyTorch call (index_select / index_copy_) as the yardstick."""
    import torch
    from repro_torch.kernels import block_copy as bc
    from repro_torch.kernels import ops
    pool, runs = case["pool"], case["runs"]
    L, K, nb, bs, H, D = pool.shape
    dev = pool.device
    p3 = pool.view(L * K, nb, bs * H * D)
    src, dst, lens, _, n_slab, rb = ops._pad_runs(runs)
    t = {k: torch.from_numpy(a).to(dev) for k, a in
         (("src", src), ("dst", dst), ("lens", lens))}
    slab = torch.zeros((L * K, n_slab, bs * H * D), dtype=pool.dtype,
                       device=dev)
    n = int(lens.sum())
    idx = torch.as_tensor([b for s, k in runs for b in range(s, s + k)],
                          device=dev)
    out = torch.empty((L * K, n, bs * H * D), dtype=pool.dtype, device=dev)
    gather = timings(
        lambda: bc.block_gather_runs(p3, slab, t["src"], t["dst"],
                                     t["lens"], rb),
        lambda: bc.copy_runs_plain(p3, slab, t["src"], t["dst"], t["lens"],
                                   rb),
        lambda: torch.index_select(p3, 1, idx, out=out), flush)
    s2, d2, l2, _, _, rb2 = ops._pad_runs(dst_runs)
    t2 = {k: torch.from_numpy(a).to(dev) for k, a in
          (("src", s2), ("dst", d2), ("lens", l2))}
    idx2 = torch.as_tensor([b for s, k in dst_runs
                            for b in range(s, s + k)], device=dev)
    target = torch.zeros_like(p3)
    scatter = timings(
        lambda: bc.block_scatter_runs(slab, target, t2["dst"], t2["src"],
                                      t2["lens"], rb2),
        lambda: bc.copy_runs_plain(slab, target, t2["dst"], t2["src"],
                                   t2["lens"], rb2),
        lambda: target.index_copy_(1, idx2, out), flush)
    row_bytes = bs * H * D * pool.element_size()
    nbytes = 2 * n * L * K * row_bytes        # each block read and written
    return gather, scatter, nbytes


# ---------------------------------------------------------------------------
# phase 3, the ops API's other kernels: per-block and grouped copies of the
# same swap chunk, flash attention, the SSD scan
# ---------------------------------------------------------------------------


def copy_2d_case(case):
    """The swap chunk of ``copy_case`` as 2-D copies over the pool's
    (C * nb, E) view into a slab-shaped (C * n_slab, E) destination (the
    gather's slab layout): per-block index pairs ``si`` -> ``di`` (C * 64
    = 3,584) and grouped runs ``g_src`` / ``g_dst`` / ``g_len`` (C * 3 =
    168, one per run and plane; also as ``run_list`` and ``dst_starts``
    for ``ops.copy_block_runs``)."""
    import torch
    from repro_torch.kernels import ops
    pool, runs = case["pool"], case["runs"]
    L, K, nb, bs, H, D = pool.shape
    C, E = L * K, bs * H * D
    _, offsets, _, _, n_slab, _ = ops._pad_runs(runs)
    si, di, g_src, g_dst, g_len = [], [], [], [], []
    for c in range(C):
        for (s, n), o in zip(runs, offsets.tolist()):
            si.extend(c * nb + s + j for j in range(n))
            di.extend(c * n_slab + o + j for j in range(n))
            g_src.append(c * nb + s)
            g_dst.append(c * n_slab + o)
            g_len.append(n)
    dev = pool.device
    as_dev = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return dict(src=pool.view(C * nb, E), n_dst=C * n_slab, E=E,
                si=as_dev(si), di=as_dev(di), g_src=as_dev(g_src),
                g_dst=as_dev(g_dst), g_len=as_dev(g_len),
                run_list=[(s, n) for s, n in zip(g_src, g_len)],
                dst_starts=g_dst, run_blocks=max(g_len))


def check_block_copies(c2, slab):
    """Per-block and grouped copies through the kernels and the plain
    versions: byte-equal with each other and with the gather's slab.
    Returns the kernels' outputs."""
    import torch
    from repro_torch.kernels import block_copy as bc
    src, dev = c2["src"], c2["src"].device
    fresh = lambda: torch.zeros((c2["n_dst"], c2["E"]), dtype=src.dtype,
                                device=dev)
    want = slab.reshape(c2["n_dst"], c2["E"]).view(torch.int16)
    outs = {}
    for name, kernel, plain, args in (
            ("block_copy", bc.block_copy, bc.block_copy_plain,
             (c2["si"], c2["di"])),
            ("block_copy_grouped", bc.block_copy_grouped,
             bc.block_copy_grouped_plain,
             (c2["g_src"], c2["g_dst"], c2["g_len"], c2["run_blocks"]))):
        out = kernel(src, fresh(), *args)
        ref = plain(src, fresh(), *args)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int16), ref.view(torch.int16)):
            raise AssertionError(f"{name}: differs from its plain version")
        if not torch.equal(out.view(torch.int16), want):
            raise AssertionError(f"{name}: differs from the gather's slab")
        outs[name] = out
    return outs


def time_block_copies(c2, flush):
    """``timings`` of both copies and the bytes each must move: every
    named block read and written once, its index lists read.  Library:
    ``index_copy_`` of an ``index_select``, the indices built on the
    device beforehand."""
    import torch
    from repro_torch.kernels import block_copy as bc
    src = c2["src"]
    dst = torch.zeros((c2["n_dst"], c2["E"]), dtype=src.dtype,
                      device=src.device)
    si, di = c2["si"].long(), c2["di"].long()
    library = lambda: dst.index_copy_(0, di, src.index_select(0, si))
    moved = 2 * c2["si"].numel() * c2["E"] * src.element_size()
    g = (c2["g_src"], c2["g_dst"], c2["g_len"], c2["run_blocks"])
    per_block = timings(
        lambda: bc.block_copy(src, dst, c2["si"], c2["di"]),
        lambda: bc.block_copy_plain(src, dst, c2["si"], c2["di"]), library,
        flush)
    grouped = timings(
        lambda: bc.block_copy_grouped(src, dst, *g),
        lambda: bc.block_copy_grouped_plain(src, dst, *g), library, flush)
    return {"block_copy": (per_block, moved + 2 * 4 * c2["si"].numel()),
            "block_copy_grouped": (grouped,
                                   moved + 3 * 4 * c2["g_src"].numel())}


def flash_case(B: int, H: int, T: int, D: int, device, seed: int):
    """Causal prefill attention inputs at qwen2-1.5b's head shape (12
    query heads, the 2 KV heads pre-expanded), bf16 N(0, 1)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((B, H, T, D), generator=g, device=device).bfloat16()
            for _ in range(3)]


def flash_work(B: int, H: int, T: int, S: int, D: int, causal: bool,
               elem: int = 2):
    """(bytes, flops) of attention for these shapes: q, k, v read and the
    output written once; QK^T and PV over the visible (row, key) pairs
    only (key col visible to row when col <= row), 2 flops per MAC."""
    pairs = (sum(min(r + 1, S) for r in range(T)) if causal else T * S)
    nbytes = (2 * B * H * T * D + 2 * B * H * S * D) * elem
    return nbytes, 4 * B * H * D * pairs


def check_flash(qkv) -> tuple:
    """(kernel output, max abs error against the plain version), every
    element within ATTN_ATOL + ATTN_RTOL * |ref|."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    out = fa.flash_attention(*qkv, causal=True)
    ref = fa.flash_attention_plain(*qkv, causal=True)
    torch.cuda.synchronize()
    return out, attention_error(out, ref, "flash_attention")


def time_flash(qkv, flush):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    return timings(
        lambda: fa.flash_attention(*qkv, causal=True),
        lambda: fa.flash_attention_plain(*qkv, causal=True),
        lambda: F.scaled_dot_product_attention(*qkv, is_causal=True), flush)


def gla_case(device, seed: int, B=1, H=112, T=4096, N=64, P=64):
    """zamba2-7b's SSD scan (d_inner 7168 = 112 heads of P 64, state N 64,
    chunk 64) over T 4096: bf16 q, k, v drawn N(0, 0.25) as
    tests/test_kernels.py draws them, logw = -exp(N(0, 0.5) - 1)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    q = (torch.randn((B, H, T, N), generator=g, device=device) * 0.5)
    k = (torch.randn((B, H, T, N), generator=g, device=device) * 0.5)
    v = (torch.randn((B, H, T, P), generator=g, device=device) * 0.5)
    logw = -torch.exp(torch.randn((B, H, T), generator=g, device=device)
                      * 0.5 - 1.0)
    return [q.bfloat16(), k.bfloat16(), v.bfloat16(), logw]


def gla_work(B: int, H: int, T: int, N: int, P: int, chunk: int,
             elem: int = 2):
    """(bytes, flops) of the chunked scan: q, k, v (``elem`` bytes) and
    logw (fp32) read once, y (``elem``) and the fp32 state written once;
    per chunk q @ S, q k^T and A @ v over the causal (i, j <= i) pairs
    only, and the state update, 2 flops per MAC."""
    nbytes = (B * H * T * (2 * N + 2 * P) * elem + B * H * T * 4
              + B * H * N * P * 4)
    tri = chunk * (chunk + 1) // 2
    macs = (T // chunk) * (2 * chunk * N * P + tri * (N + P))
    return nbytes, 2 * B * H * macs


def gla_errors(y, s, want_y, want_s) -> tuple:
    """Max abs errors of y and S; raises where an element of y is off by
    more than GLA_Y_ATOL + ATTN_RTOL * |ref| or of S by more than
    GLA_S_ATOL + GLA_S_RTOL * |ref|."""
    errs = []
    for what, out, ref, atol, rtol in (
            ("y", y, want_y, GLA_Y_ATOL, ATTN_RTOL),
            ("S", s, want_s, GLA_S_ATOL, GLA_S_RTOL)):
        out, ref = out.float(), ref.float()
        diff = (out - ref).abs()
        excess = float((diff - rtol * ref.abs()).max())
        err = float(diff.max())
        if not (math.isfinite(err) and excess <= atol):
            raise AssertionError(f"gla_scan_scalar: {what} max abs error "
                                 f"{err}, an element {excess} above {rtol} "
                                 f"* |ref| (allowed {atol})")
        errs.append(err)
    return tuple(errs)


def check_gla(case) -> tuple:
    """((y, S) of the kernel, (y error, S error)) against the plain
    version."""
    import torch
    from repro_torch.kernels import gla_scan as gla
    y, s = gla.gla_scan_scalar(*case, chunk=64)
    want_y, want_s = gla.gla_scan_scalar_plain(*case, chunk=64)
    torch.cuda.synchronize()
    return (y, s), gla_errors(y, s, want_y, want_s)


def time_gla(case, flush):
    from repro_torch.kernels import gla_scan as gla
    return timings(lambda: gla.gla_scan_scalar(*case, chunk=64),
                   lambda: gla.gla_scan_scalar_plain(*case, chunk=64), None,
                   flush)


def run_ops_path(c2, qkv, gla_in, outs):
    """This slice's path: the public kernel API ``repro_torch.kernels.ops``
    once per kernel at the full widths above, the launch counts set to 0
    just before and read just after.  Outputs must equal the checked
    kernel outputs ``outs`` bit for bit (the kernels are deterministic)."""
    import torch
    from repro_torch.kernels import block_copy as bc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gla_scan as gla
    from repro_torch.kernels import ops
    counted = (bc.block_copy, bc.block_copy_grouped, fa.flash_attention,
               gla.gla_scan_scalar)
    src = c2["src"]
    fresh = lambda: torch.zeros((c2["n_dst"], c2["E"]), dtype=src.dtype,
                                device=src.device)
    dst_pb, dst_g = fresh(), fresh()
    for fn in counted:
        fn.launches = 0
    got = {"block_copy": ops.copy_blocks(src, dst_pb, c2["si"], c2["di"]),
           "block_copy_grouped": ops.copy_block_runs(
               src, dst_g, c2["run_list"], c2["dst_starts"]),
           "flash_attention": ops.flash_attention(*qkv, causal=True),
           "gla_scan_scalar": ops.gla_scan_scalar(*gla_in, chunk=64)}
    launches = {fn.__name__: fn.launches for fn in counted}
    torch.cuda.synchronize()
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the ops path never launched: "
                             f"{launches}")
    bits = lambda t: t.contiguous().view(torch.uint8)   # NaN bits too
    for name, out in got.items():
        outs_n = out if isinstance(out, tuple) else (out,)
        want = outs[name] if isinstance(outs[name], tuple) else (outs[name],)
        if not all(torch.equal(bits(a), bits(b))
                   for a, b in zip(outs_n, want)):
            raise AssertionError(f"ops path: {name} differs from the "
                                 "checked kernel output")
    return launches


# ---------------------------------------------------------------------------
# phase 3c: the swap plane, three ways, against the host link
# ---------------------------------------------------------------------------

# the pools' block layouts of the two served models: L layers x K/V x
# 16 tokens x Hkv heads x D bf16 (qwen2-1.5b 448 KiB a block, olmoe-1b-7b
# 2 MiB)
SWAP_LAYOUTS = {"qwen2-1.5b": dict(L=28, Hkv=2, D=128),
                "olmoe-1b-7b": dict(L=16, Hkv=16, D=128)}
# one 64-block swap: phase 3's chunk, three runs
SWAP_RUNS = ((3, 20), (40, 12), (100, 32))
# the swap counts of the engine and moe phases' held runs at full width
# (swap-outs, swap-in sub-slabs), as every run since PR 17 (qwen2) and
# PR 20 (olmoe) gave them
ENGINE_SWAPS = (81, 156)
MOE_SWAPS = (74, 142)
# the host seconds in the staged calls before the swap plane had streams
# of its own (PERF.md, PR 20: qwen2 call 6, olmoe call 7)
EARLIER_STAGED_S = {
    "qwen2-1.5b": {"copy_in_staged": 0.463, "copy_out_staged": 0.281,
                   "source": "PERF.md, PR 20 call 6"},
    "olmoe-1b-7b": {"copy_in_staged": 2.098, "copy_out_staged": 0.492,
                    "source": "PERF.md, PR 20 call 7"}}


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def swap_pools(device, seed: int, L: int, Hkv: int, D: int, bs: int = 16,
               nb: int = 160, nc: int = 160):
    """A ``PagedPools`` of ``nb`` device and ``nc`` host blocks at the
    layout (L, Hkv, D), the device pool filled with seeded normal bf16
    values; with the swap's runs, its block ids and 64 scattered host
    block ids."""
    import numpy as np
    import torch
    from repro_torch.cache.paged import PagedPools, PoolSpec
    spec = PoolSpec(n_layers=L, n_kv_heads=Hkv, head_dim=D, block_size=bs,
                    num_gpu_blocks=nb, num_cpu_blocks=nc)
    pools = PagedPools(spec, device=device)
    pools.gpu.normal_(generator=torch.Generator(device=device)
                      .manual_seed(seed))
    runs = list(SWAP_RUNS)
    blocks = [b for s, n in runs for b in range(s, s + n)]
    cpu_ids = np.random.RandomState(seed).permutation(nc)[:len(blocks)]
    _sync(device)
    return pools, runs, blocks, [int(c) for c in cpu_ids]


def swap_ways(pools, runs, blocks, cpu_ids, repeats: int = 3) -> dict:
    """One 64-block swap out of the device pool and back in, three ways,
    ``repeats`` times each: ``per_block`` (a ``copy_out([g], [c])`` per
    block, then a ``copy_in([c], [g])`` per block), ``one_call`` (one
    ``copy_out`` and one ``copy_in`` for all blocks) and ``staged``
    (``copy_out_staged`` / ``copy_in_staged`` over the runs).  Every way's
    host blocks must equal the device blocks before, byte for byte, and
    so must the device blocks after its swap-in (which starts from
    zeroed blocks).  Host ms of each leg and GB/s over the swap's bytes;
    beside them, the host link's own rate: one pinned ``copy_`` of the
    same bytes each way, ``repeats`` times."""
    import numpy as np
    import torch
    dev = pools.device
    idx = torch.as_tensor(blocks, device=dev)
    before = pools.gpu[:, :, idx].clone()
    want = before.cpu().view(torch.int16).numpy().view(np.uint16)
    nbytes = len(blocks) * pools.spec.block_bytes()
    pairs = list(zip(blocks, cpu_ids))
    legs = {
        "per_block": (lambda: [pools.copy_out([g], [c]) for g, c in pairs],
                      lambda: [pools.copy_in([c], [g]) for g, c in pairs]),
        "one_call": (lambda: pools.copy_out(blocks, cpu_ids),
                     lambda: pools.copy_in(cpu_ids, blocks)),
        "staged": (lambda: pools.copy_out_staged(runs, cpu_ids),
                   lambda: pools.copy_in_staged(cpu_ids, runs))}
    out = {}
    for way, (leg_out, leg_in) in legs.items():
        rec = out[way] = {"out_ms": [], "in_ms": []}
        for _ in range(repeats):
            pools.cpu[:, :, cpu_ids] = 0
            t0 = time.perf_counter()
            leg_out()
            rec["out_ms"].append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(pools.cpu[:, :, cpu_ids], want):
                raise AssertionError(f"swap {way}: the host blocks differ "
                                     "from the device blocks before")
            pools.gpu[:, :, idx] = 0
            _sync(dev)
            t0 = time.perf_counter()
            leg_in()
            _sync(dev)
            rec["in_ms"].append((time.perf_counter() - t0) * 1e3)
            if not _bytes_equal(pools.gpu[:, :, idx], before):
                raise AssertionError(f"swap {way}: the device blocks after "
                                     "the swap-in differ from before")
        for leg in ("out", "in"):
            rec[f"{leg}_gb_s"] = [nbytes / ms / 1e6 for ms in rec[f"{leg}_ms"]]
    link = {"d2h_ms": [], "h2d_ms": []}
    if dev.type == "cuda":
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        for _ in range(repeats):
            for key, dst, src in (("d2h_ms", host, buf), ("h2d_ms", buf, host)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dst.copy_(src, non_blocking=True)
                torch.cuda.synchronize()
                link[key].append((time.perf_counter() - t0) * 1e3)
        for key in ("d2h", "h2d"):
            link[f"{key}_gb_s"] = [nbytes / ms / 1e6
                                   for ms in link[f"{key}_ms"]]
    return {"bytes": nbytes, "block_bytes": pools.spec.block_bytes(),
            "blocks": len(blocks), "runs": [list(r) for r in runs],
            "ways": out, "link": link,
            "byte_equal": "every way's host and device blocks equal the "
                          "device blocks before"}


def swap_phase(device, layouts=None, repeats: int = 3) -> dict:
    """``swap_ways`` at each layout of ``layouts`` (by default both served
    models' pools, ``SWAP_LAYOUTS``)."""
    out = {}
    for i, (arch, layout) in enumerate((layouts or SWAP_LAYOUTS).items()):
        pools, runs, blocks, cpu_ids = swap_pools(device, 7 + i, **layout)
        out[arch] = swap_ways(pools, runs, blocks, cpu_ids, repeats)
        del pools
    return out


def _union(spans):
    """Merged (start, end) intervals of ``spans``."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap_us(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_from_trace(events, slab_bytes: int) -> dict:
    """A staged swap-in beside a decode replay, read from a profiler trace
    (``export_chrome_trace``'s ``traceEvents``): the uploads are the
    host-to-device copies of at least ``slab_bytes``, the scatters the
    run-copy kernels, and the swap's streams theirs; every other device
    operation is the replay's.  Returns the device time in which the
    swap's operations overlap the replay's, each side's span, the swap's
    end after the replay's start, and per sub-slab k whether upload k+1
    starts before scatter k ends."""
    dev_ops = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    ups = sorted((e for e in dev_ops if e["cat"] == "gpu_memcpy"
                  and "HtoD" in e["name"]
                  and e.get("args", {}).get("bytes", 0) >= slab_bytes),
                 key=lambda e: e["ts"])
    scs = sorted((e for e in dev_ops if e["cat"] == "kernel"
                  and "copy_runs_kernel" in e["name"]),
                 key=lambda e: e["ts"])
    if not ups or len(ups) != len(scs):
        raise AssertionError(f"the trace holds {len(ups)} slab uploads and "
                             f"{len(scs)} scatters: one each per sub-slab")
    swap_streams = {e["args"]["stream"] for e in ups + scs}
    swap = [e for e in dev_ops if e["args"]["stream"] in swap_streams]
    replay = [e for e in dev_ops if e["args"]["stream"] not in swap_streams]
    if not replay:
        raise AssertionError("the trace holds no operation of the replay")
    span = lambda ev: (min(e["ts"] for e in ev),
                       max(e["ts"] + e["dur"] for e in ev))
    (r0, r1), (s0, s1) = span(replay), span(swap)
    ahead = [ups[k + 1]["ts"] < scs[k]["ts"] + scs[k]["dur"]
             for k in range(len(scs) - 1)]
    return {"overlap_ms": _overlap_us(
                _union((e["ts"], e["ts"] + e["dur"]) for e in swap),
                _union((e["ts"], e["ts"] + e["dur"]) for e in replay)) / 1e3,
            "replay_span_ms": (r1 - r0) / 1e3, "swap_span_ms": (s1 - s0) / 1e3,
            "swap_end_after_replay_start_ms": (s1 - r0) / 1e3,
            "sub_slabs": len(scs), "upload_next_before_scatter_ends": ahead,
            "replay_ops": len(replay), "swap_ops": len(swap)}


def overlap_probe(replay, device, repeats: int = 3) -> dict:
    """A staged swap-in of 64 blocks at olmoe-1b-7b's pool layout (its own
    pool, so no block is shared with the replay) issued from a worker
    thread while ``replay`` (one captured decode step) runs on this
    thread's stream, back to back as the engine decodes, under
    ``torch.profiler`` (``overlap_from_trace``): as many replays are
    queued first as cover the swap-in alone, plus one, since its host
    gathers take about as long as one replay.  Beside it the replay alone
    (CUDA events) and the swap-in alone (host ms of ``copy_in_staged``),
    ``repeats`` times each, and the host ms of the worker's call in the
    overlapped run.  The swapped-in blocks must equal the blocks swapped
    out."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    pools, runs, blocks, cpu_ids = swap_pools(
        device, 11, **SWAP_LAYOUTS["olmoe-1b-7b"])
    idx = torch.as_tensor(blocks, device=pools.device)
    pools.copy_out_staged(runs, cpu_ids)
    want = pools.gpu[:, :, idx].clone()

    def swap_in():
        pools.gpu[:, :, idx] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pools.copy_in_staged(cpu_ids, runs)
        return (time.perf_counter() - t0) * 1e3
    swap_alone = [swap_in() for _ in range(repeats)]
    replay_alone = [time_ms(replay, iters=5, warmup=1)
                    for _ in range(repeats)]
    n_replays = math.ceil(sorted(swap_alone)[repeats // 2]
                          / min(replay_alone)) + 1
    stage = pools.stage_blocks * pools.spec.block_bytes()

    def beside():
        """The profiled run; a session that comes back without the
        swap's or the replay's device events is made again
        (``remeasured``)."""
        pools.gpu[:, :, idx] = 0
        torch.cuda.synchronize()
        worker = {}

        def run():
            t0 = time.perf_counter()
            try:
                pools.copy_in_staged(cpu_ids, runs)
            except BaseException as fault:    # raised on this thread below
                worker["fault"] = fault
            worker["ms"] = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_replays):
                replay()
            th = threading.Thread(target=run)
            th.start()
            th.join()
            torch.cuda.synchronize()
        if "fault" in worker:
            raise worker["fault"]
        if not _bytes_equal(pools.gpu[:, :, idx], want):
            raise AssertionError("the swap-in beside the replay restored "
                                 "other bytes than were swapped out")
        with tempfile.NamedTemporaryFile(suffix=".json") as f:
            prof.export_chrome_trace(f.name)
            with open(f.name) as trace:
                events = json.load(trace)["traceEvents"]
        return overlap_from_trace(events, stage), worker["ms"]
    out, host_ms = remeasured(beside)
    out.update(replays=n_replays, replay_alone_ms=replay_alone,
               swap_in_alone_ms=swap_alone,
               swap_in_beside_replay_host_ms=host_ms,
               blocks=len(blocks), block_bytes=pools.spec.block_bytes(),
               sub_slab_bytes=stage)
    return out


# ---------------------------------------------------------------------------
# phase 4: the engine
# ---------------------------------------------------------------------------


def conversations(n_convs: int, prompt_tokens, followup_tokens,
                  max_tokens: int):
    """``n_convs`` two-turn conversations, all arriving at t = 0."""
    from repro_torch.data.sharegpt import Conversation, Turn
    return [Conversation(conv_id=i, arrival_s=0.0,
                         turns=[Turn(prompt_tokens[i % len(prompt_tokens)],
                                     max_tokens),
                                Turn(followup_tokens[i % len(followup_tokens)],
                                     max_tokens)],
                         think_time_s=0.05)
            for i in range(n_convs)]


def _time_methods(pairs):
    """Wrap each (object, method name) so its calls add their host
    seconds to the returned dict (no extra device synchronisation: a
    decode step's time includes the wait for the previous step's tokens
    in ``flush``, and a swap copy's its own stream synchronise)."""
    totals = {}
    lock = threading.Lock()
    for obj, name in pairs:
        fn = getattr(obj, name)

        def wrapped(*a, _fn=fn, _key=name, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                with lock:
                    totals[_key] = (totals.get(_key, 0.0)
                                    + time.perf_counter() - t0)
        setattr(obj, name, wrapped)
    return totals


def _count_swaps(swap):
    """Wrap ``swap.dispatch`` so every swap that moves data counts under
    (request id, direction) in the returned dict."""
    counts = {}
    dispatch = swap.dispatch

    def wrapped(clock, req_id, direction, *a, **k):
        if k.get("copy_fn") is not None:
            key = (req_id, direction)
            counts[key] = counts.get(key, 0) + 1
        return dispatch(clock, req_id, direction, *a, **k)
    swap.dispatch = wrapped
    return counts


def run_engine(bundle, convs, *, gpu_blocks: int, cpu_blocks: int,
               max_running: int, seed: int = 13, mesh=(1, 1),
               on_engine=None, policy: str = "fastswitch"):
    """Serve ``convs`` through the replay client of ``ServingEngine`` in
    real mode (``policy``, a random priority storm) on ``mesh``
    (the bundle's ``mesh_devices`` name its devices); ``on_engine`` is
    called with the engine before it runs.  Returns (engine, wall
    seconds, host seconds by method, data-moving swaps by (request id,
    direction)); the wall time ends in a device synchronise."""
    import torch
    from repro_torch.core import EngineConfig, FastSwitchEngine
    from repro_torch.data.priority import PriorityTrace
    cfg = EngineConfig(mode="real", num_gpu_blocks=gpu_blocks,
                       num_cpu_blocks=cpu_blocks, max_running=max_running,
                       max_batch=max_running, block_size=16,
                       seed=SEED, mesh_shape=tuple(mesh)
                       ).with_policy(policy)
    eng = FastSwitchEngine(cfg, convs, trace=PriorityTrace("random", 0.5,
                                                           seed=seed),
                           model_bundle=bundle)
    host = _time_methods([(eng.runner, "decode"),
                          (eng.runner, "flush"),
                          (eng.runner, "_scatter_rows"),
                          (eng.runner, "prefill_chunk_compute"),
                          (eng.pools, "copy_out_staged"),
                          (eng.pools, "copy_in_staged")])
    swaps = _count_swaps(eng.swap)
    if on_engine is not None:
        on_engine(eng)
    t0 = time.perf_counter()
    eng.run(max_iterations=100_000)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return eng, time.perf_counter() - t0, host, swaps


def check_engine(eng, convs, swaps, expect_swaps=None,
                 every_conv_swapped: bool = True) -> dict:
    """Every turn finished, preemption happened, every conversation was
    swapped out and back in (with ``every_conv_swapped``; else the run
    swapped both ways), no swap copy failed, and, given
    ``expect_swaps`` (swap-outs, swap-in sub-slabs), the run made exactly
    those staged calls.  A copy that raises
    (a failed build or launch, a wrapper's refusal) is retried and then
    recovered by recomputing the request's KV, so the turns still finish:
    only the failure counters show it."""
    m = eng.metrics
    if not eng.done():
        raise AssertionError("the engine did not finish every turn")
    want = sum(t.response_tokens for c in convs for t in c.turns)
    if m.total_tokens != want:
        raise AssertionError(f"{m.total_tokens} tokens generated, "
                             f"{want} expected")
    pools, sw = eng.pools, eng.swap
    failures = {"copy_retries": sw.n_retries,
                "copy_failures": sw.n_copy_failures,
                "watchdog_rescues": sw.n_watchdog,
                "pending_failed_tasks": len(sw.failed_tasks),
                "swap_failure_resumes": m.swap_failure_resumes,
                "faulted": m.faulted, "dropped": m.dropped}
    if any(failures.values()):
        raise AssertionError(f"the swap plane or a request failed: "
                             f"{failures}")
    if m.preemptions <= 0:
        raise AssertionError("no preemption: the pool was not small enough")
    if pools.staged_out_calls <= 0 or pools.staged_in_calls <= 0:
        raise AssertionError(f"swaps out {pools.staged_out_calls}, in "
                             f"{pools.staged_in_calls}: both must be > 0")
    made = (pools.staged_out_calls, pools.staged_in_calls)
    if expect_swaps is not None and made != tuple(expect_swaps):
        raise AssertionError(f"staged swaps out and in {made}, expected "
                             f"{tuple(expect_swaps)}")
    by_conv = {c.conv_id: [swaps.get((c.conv_id, "out"), 0),
                           swaps.get((c.conv_id, "in"), 0)] for c in convs}
    unswapped = [c for c, (o, i) in by_conv.items() if o <= 0 or i <= 0]
    if unswapped and every_conv_swapped:
        raise AssertionError(f"conversations {unswapped} were not swapped "
                             f"both ways: {by_conv}")
    st = eng.runner.stats
    if st.eager_steps + st.graph_replays != st.steps:
        raise AssertionError(f"{st.steps} decode steps, {st.eager_steps} "
                             f"eager and {st.graph_replays} replayed")
    if not st.graphs_captured == eng.runner.graph_cache_size() \
            == st.rebuilds == st.eager_steps:
        raise AssertionError(f"{st.graphs_captured} graphs captured, "
                             f"{st.rebuilds} bucket rebuilds, "
                             f"{st.eager_steps} eager steps: one each per "
                             "bucket")
    return {"turns": sum(len(c.turns) for c in convs),
            "tokens": m.total_tokens, "preemptions": m.preemptions,
            "swap_out_calls": pools.staged_out_calls,
            "swap_in_calls": pools.staged_in_calls,
            "fenced_swap_ins": pools.fenced_swap_ins,
            "d2h_transfers": pools.d2h_transfers,
            "h2d_transfers": pools.h2d_transfers,
            "swaps_out_in_by_conv": by_conv, **failures,
            "decode_steps": st.steps,
            "graphs_captured": st.graphs_captured,
            "graph_replays": st.graph_replays, "eager_steps": st.eager_steps,
            "batch_bucket": eng.runner.batch_bucket,
            "prefill_chunks": st.prefill_chunks}


def _bytes_equal(a, b) -> bool:
    """Byte equality of two tensors, or of two per-shard lists shard by
    shard."""
    import torch
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_bytes_equal, a, b))
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def _clone(t):
    """A clone of a tensor, or of each shard of a per-shard list."""
    if isinstance(t, (list, tuple)):
        return [x.clone() for x in t]
    return t.clone()


@contextlib.contextmanager
def replays_held_to_eager():
    """Within the block, the first replay of each captured decode-step
    variant (``decode_runner._StepGraph``: a bucket's argmax-only and
    sampled graphs) is held against an eager step of the same body over
    clones of the state it replays over: the next tokens, the pool, the
    context lengths and the last tokens must be equal byte for byte.
    Yields the list of checked (bucket, variant), filled as the engine
    runs; raises ``AssertionError`` at a difference."""
    from repro_torch.core import decode_runner as dr
    real = dr._StepGraph.replay
    checked = []

    def replay(graph, tensors):
        bucket = list(tensors[dr.STEP_TENSORS.index("block_tables")].shape)
        sampled = graph._step.keywords["sampled"]
        if any(c["bucket"] == bucket and c["sampled"] == sampled
               for c in checked):
            return real(graph, tensors)
        clones = [_clone(t) for t in tensors]
        nxt = real(graph, tensors)
        want = graph._step(*clones)           # eager, on the clones
        equal = {"nxt": _bytes_equal(nxt, want)}
        for name in ("pool", "context_lens", "tokens"):
            i = dr.STEP_TENSORS.index(name)
            equal[name] = _bytes_equal(tensors[i], clones[i])
        checked.append({"bucket": bucket, "sampled": sampled,
                        "byte_equal": equal})
        if not all(equal.values()):
            raise AssertionError(f"bucket {bucket}, sampled {sampled}: the "
                                 f"replayed step differs from the eager "
                                 f"one: {equal}")
        return nxt
    dr._StepGraph.replay = replay
    try:
        yield checked
    finally:
        dr._StepGraph.replay = real


def ops_named(events, part: str) -> dict:
    """{full name: [count, device ms]} of the profiler device events
    whose name holds ``part``."""
    out = {}
    for e in events:
        if part in e.name:
            n_ms = out.setdefault(e.name, [0, 0.0])
            n_ms[0] += 1
            n_ms[1] += (e.time_range.end - e.time_range.start) / 1e3
    return out


def busy_seconds(spans) -> float:
    """Length of the union of (start, end) intervals in µs, in seconds."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6


def profile_engine(bundle, convs, **sizes) -> dict:
    """One more engine run under ``torch.profiler``: the share of its wall
    time in which the device ran nothing (its kernels and copies merged
    into busy intervals) and the device operations by total time.  The
    profiler slows the host, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import paged_attention as pa
    pa.paged_attention.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng, wall, _, swaps = run_engine(bundle, convs, **sizes)
    counted = pa.paged_attention.launches
    stats = check_engine(eng, convs, swaps)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler recorded no device operation")
    busy = busy_seconds((e.time_range.start, e.time_range.end) for e in dev)
    by_name = {}
    for e in dev:
        n_us = by_name.setdefault(e.name[:80], [0, 0.0])
        n_us[0] += 1
        n_us[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    paged = ops_named(dev, "paged_attention")
    if not paged:
        raise AssertionError("no paged-attention kernel in the profile")
    if any(c != counted for c, _ in paged.values()):
        raise AssertionError(f"the profiler saw the paged-attention kernels "
                             f"{ {n: c for n, (c, _) in paged.items()} } "
                             f"times, the wrapper counted {counted}")
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "device_ops": len(dev), "decode_steps": eng.runner.stats.steps,
            "graph_replays": stats["graph_replays"],
            "paged_attention_launches_counted": counted,
            "top_device_ops": [{"name": n, "count": c, "ms": us / 1e3}
                               for n, (c, us) in top],
            "paged_attention_ops": [{"name": n, "count": c, "ms": ms}
                                    for n, (c, ms) in paged.items()],
            "paged_attention_ms": sum(ms for _, ms in paged.values())}


# ---------------------------------------------------------------------------
# phase 5: greedy tokens against a plain dense forward
# ---------------------------------------------------------------------------


def check_tokens(eng, bundle, conv, tol: float = NEAR_TIE) -> dict:
    """Teacher-force the conversation's full history through the plain
    dense forward once; every token the engine generated must be the
    dense argmax at its position, or within ``tol`` of the dense maximum
    (a near-tie)."""
    hist = eng._token_hist_by_conv[conv.conv_id]
    generated = generated_positions(conv)
    n = sum(t.prompt_tokens + t.response_tokens for t in conv.turns)
    if len(hist) != n:
        raise AssertionError(f"history holds {len(hist)} tokens, the turns "
                             f"{n}")
    return {"conv": conv.conv_id,
            **check_history(bundle, hist, generated, tol)}


def generated_positions(conv) -> list:
    """The history positions of ``conv``'s response tokens."""
    out, pos = [], 0
    for turn in conv.turns:
        pos += turn.prompt_tokens
        out.extend(range(pos, pos + turn.response_tokens))
        pos += turn.response_tokens
    return out


def dense_logits(bundle, hist, positions, frames=None):
    """The plain dense forward of ``hist`` (an encoder-decoder against its
    ``frames`` (1, S_enc, d)), its fp32 logits predicting each of
    ``positions`` (the rows at ``positions - 1``): (n, V)."""
    import torch
    from repro_torch.models import transformer as T
    device = bundle["params"]["embed"]["table"].device
    toks = torch.tensor([list(hist)], dtype=torch.long, device=device)
    with torch.no_grad():
        logits, _, _ = T.forward_seq(bundle["params"], bundle["cfg"], toks,
                                     encoder_frames=frames)
    return logits[0, [i - 1 for i in positions]].float()


def token_gaps(rows, hist, generated, tol: float = NEAR_TIE) -> dict:
    """The token of ``hist`` at each position in ``generated`` against
    ``rows`` (``dense_logits`` there): it must be the argmax of its row,
    or within ``tol`` of the row's maximum (a near-tie).  Counts the
    tokens equal to the argmax and those within ``NEAR_TIE``."""
    import torch
    want = torch.tensor([hist[i] for i in generated], device=rows.device)
    gap = rows.max(dim=-1).values - rows.gather(1, want[:, None])[:, 0]
    equal = int((gap == 0).sum())
    worst = float(gap.max())
    if worst >= tol:
        i = int(gap.argmax())
        raise AssertionError(f"token {generated[i]}: the engine's token is "
                             f"{worst} below the dense maximum (>= {tol})")
    return {"generated": len(generated), "equal": equal,
            "near_ties": len(generated) - equal,
            "within_near_tie": int((gap < NEAR_TIE).sum()),
            "max_gap": worst, "tolerance": tol}


def check_history(bundle, hist, generated, tol: float = NEAR_TIE,
                  frames=None) -> dict:
    """Teacher-force ``hist`` through the plain dense forward once (an
    encoder-decoder against its ``frames`` (1, S_enc, d)); the token at
    each position in ``generated`` must be the dense argmax there, or
    within ``tol`` of the dense maximum (``token_gaps``)."""
    if not generated:
        return {"generated": 0, "equal": 0, "near_ties": 0,
                "within_near_tie": 0, "max_gap": 0.0, "tolerance": tol}
    return token_gaps(dense_logits(bundle, hist, generated, frames), hist,
                      generated, tol)


def exact_shape_history(bundle, conv, want, block_size: int = 16,
                        tol: float = NEAR_TIE) -> dict:
    """Replay one conversation straight through the exact-shape data plane:
    each turn's prompt (``synth_prompt_ids``, as the replay client sends
    it) appended to the history, ``prefill_kv`` of the whole history,
    ``PagedPools.write_tokens`` of its K/V from block 0, the greedy first
    token, then one ``paged_decode_step`` (batch 1, the block table of the
    context's pages) per further token: the schedule-independent greedy
    oracle.  ``want`` (the engine's history) must equal it; a first
    difference is accepted only where the oracle's logits of its token
    and the engine's lie within ``tol`` (a near-tie), and ends the
    comparison there.  Returns the record; with ``want`` None, nothing is
    compared and the record holds the oracle's ``history``."""
    import torch
    from repro_torch.cache.paged import PagedPools, PoolSpec
    from repro_torch.data.sharegpt import synth_prompt_ids
    from repro_torch.models.paged import paged_decode_step, prefill_kv
    cfg, params = bundle["cfg"], bundle["params"]
    device = params["embed"]["table"].device
    n_tok = sum(t.prompt_tokens + t.response_tokens for t in conv.turns)
    pools = PagedPools(PoolSpec.from_config(
        cfg, -(-n_tok // block_size) + 1, 1, block_size), device=device)
    hist, gaps = [], []
    rec = {"conv": conv.conv_id, "tokens": n_tok, "generated": 0,
           "first_difference": None}

    def take(logits) -> bool:
        """Append the oracle's token; False once the engine's differs."""
        tok = int(logits.argmax())
        pos = len(hist)
        hist.append(tok)
        rec["generated"] += 1
        if want is None or pos >= len(want) or want[pos] == tok:
            return True
        gap = float(logits[tok] - logits[want[pos]])
        rec["first_difference"] = {"position": pos, "oracle": tok,
                                   "engine": want[pos], "logit_gap": gap}
        if gap >= tol:
            raise AssertionError(f"conversation {conv.conv_id}, position "
                                 f"{pos}: the engine's token {want[pos]} is "
                                 f"{gap} below the exact-shape oracle's "
                                 f"{tok} (>= {tol})")
        return False
    with torch.no_grad():
        for tix, turn in enumerate(conv.turns):
            hist.extend(synth_prompt_ids(conv.conv_id, tix,
                                         turn.prompt_tokens, cfg.vocab_size))
            if want is not None and list(want[:len(hist)]) != hist:
                raise AssertionError(f"conversation {conv.conv_id}, turn "
                                     f"{tix}: the engine's prompt ids differ "
                                     "from the replay client's")
            toks = torch.tensor([hist], dtype=torch.long, device=device)
            logits, k, v = prefill_kv(params, toks, cfg=cfg)
            nblk = -(-len(hist) // block_size)
            pools.write_tokens(list(range(nblk)), 0, k, v)
            if not take(logits.float().cpu()):
                return rec
            for _ in range(turn.response_tokens - 1):
                ctx = len(hist) - 1
                bt = torch.tensor([list(range(ctx // block_size + 1))],
                                  dtype=torch.int32, device=device)
                _, logits, pools.gpu = paged_decode_step(
                    params, pools.gpu, bt,
                    torch.tensor([ctx], dtype=torch.int32, device=device),
                    torch.tensor([hist[-1]], dtype=torch.int32,
                                 device=device), cfg=cfg)
                if not take(logits[0].cpu()):
                    return rec
    if want is None:
        rec["history"] = hist
    elif hist != list(want):
        raise AssertionError(f"conversation {conv.conv_id}: the engine's "
                             f"history ({len(want)} tokens) differs from "
                             f"the oracle's ({len(hist)}) outside any "
                             "generated position")
    return rec


def check_oracle(eng, bundle, convs, tol: float = NEAR_TIE) -> dict:
    """``exact_shape_history`` of every conversation against the engine's
    token history."""
    rows = [exact_shape_history(bundle, c, eng._token_hist_by_conv[c.conv_id],
                                tol=tol) for c in convs]
    return {"conversations": len(rows),
            "equal": sum(r["first_difference"] is None for r in rows),
            "near_ties": [r["first_difference"] for r in rows
                          if r["first_difference"] is not None],
            "generated": sum(r["generated"] for r in rows),
            "tolerance": tol}


def first_divergence(bundle, a, b):
    """(position, |logit gap| of the two tokens there under the plain
    dense forward of the shared prefix) of the first position where the
    token lists ``a`` and ``b`` differ; None where one is a prefix of the
    other."""
    import torch
    from repro_torch.models import transformer as T
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            device = bundle["params"]["embed"]["table"].device
            toks = torch.tensor([a[:i]], dtype=torch.long, device=device)
            with torch.no_grad():
                logits, _, _ = T.forward_seq(bundle["params"], bundle["cfg"],
                                             toks)
            return i, float((logits[0, -1, x] - logits[0, -1, y]).abs())
    return None


# ---------------------------------------------------------------------------
# phase 5b: sampled requests
# ---------------------------------------------------------------------------


def row_key(seed: int, rid: int, salt: int = 0):
    """The runner's base key of request ``rid`` (``DecodeRunner._row_key``,
    the reference's fold of (seed, rid[, salt])), on the CPU."""
    from repro_torch.models import prng
    k = prng.fold_in(prng.prng_key(seed), rid)
    return prng.fold_in(k, salt) if salt else k


def sampled_apart(logits, key, ctx: int, smp, a: int, b: int,
                  tol: float = NEAR_TIE) -> str:
    """Why the draw at ``ctx`` with ``key`` may be either token a or b when
    the logits are known only to ``tol``: "tie" where their scaled logits
    plus Gumbel noise lie within tol / temperature, "top_k" where either
    scaled logit lies that close to the top-k threshold, "nucleus" where
    the nucleus mass before either lies within ``NUCLEUS_EPS`` of top_p;
    "" where none holds.  ``logits`` (V,), on the CPU."""
    import torch
    from repro_torch.models import prng
    t, k, p = (float(v) for v in smp)
    scaled = logits.float().cpu() / max(t, 1e-6)
    V = scaled.shape[-1]
    noisy = scaled + prng.gumbel(prng.fold_in(key, ctx), (V,))
    if abs(float(noisy[a] - noisy[b])) < tol / t:
        return "tie"
    vals, order = torch.sort(scaled, descending=True)
    if k > 0 and any(abs(float(scaled[x] - vals[int(k) - 1])) < tol / t
                     for x in (a, b)):
        return "top_k"
    probs = torch.softmax(vals.double(), dim=-1)
    before = torch.cumsum(probs, 0) - probs
    rank = torch.empty_like(order)
    rank[order] = torch.arange(V)
    if any(abs(float(before[rank[x]]) - p) < NUCLEUS_EPS for x in (a, b)):
        return "nucleus"
    return ""


def check_sampled_tokens(eng, bundle, conv, smp, seed: int = SEED,
                         tol: float = NEAR_TIE) -> dict:
    """Teacher-force the conversation's history through the plain dense
    forward once; every token the engine generated must be the draw of
    the plain sampler on the CPU (``models.paged.sample_tokens``) from the
    dense logits at its position, with the request's key: salted 1 at
    position len(history) for a turn's first token, as the prefill emits
    it, else at the previous position, as a decode step draws.  A token
    it does not draw must be explained by ``sampled_apart``."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.paged import sample_tokens
    hist = eng._token_hist_by_conv[conv.conv_id]
    firsts, generated, pos = set(), [], 0
    for turn in conv.turns:
        pos += turn.prompt_tokens
        firsts.add(pos)
        generated.extend(range(pos, pos + turn.response_tokens))
        pos += turn.response_tokens
    if len(hist) != pos:
        raise AssertionError(f"history holds {len(hist)} tokens, the turns "
                             f"{pos}")
    device = bundle["params"]["embed"]["table"].device
    toks = torch.tensor([hist], dtype=torch.long, device=device)
    with torch.no_grad():
        logits, _, _ = T.forward_seq(bundle["params"], bundle["cfg"], toks)
    lg = logits[0, [i - 1 for i in generated]].float().cpu()
    smp_t = torch.tensor([list(smp)], dtype=torch.float32)
    equal, why = 0, []
    for j, i in enumerate(generated):
        first = i in firsts
        key = row_key(seed, conv.conv_id, salt=1 if first else 0)
        ctx = i if first else i - 1
        want = int(sample_tokens(lg[j][None], key[None],
                                 torch.tensor([ctx]), smp_t)[0])
        if hist[i] == want:
            equal += 1
            continue
        reason = sampled_apart(lg[j], key, ctx, smp, hist[i], want, tol)
        if not reason:
            raise AssertionError(f"conversation {conv.conv_id}, token {i}: "
                                 f"the engine drew {hist[i]}, the plain "
                                 f"sampler {want}, and no near-tie explains "
                                 "it")
        why.append(reason)
    return {"conv": conv.conv_id, "generated": len(generated),
            "equal": equal, "near_ties": why}


def run_sampling(bundle, n_requests: int = 8,
                 prompt_tokens=(256, 288, 320, 352), max_tokens: int = 32,
                 gpu_blocks: int = 256, sampling=SAMPLING, mesh=(1, 1)):
    """Serve ``n_requests`` single-turn requests in one batch through
    ``ServingEngine`` in real mode on ``mesh``: odd handles sample at
    ``sampling`` (greedy too where it is None), even ones are greedy.
    Returns (engine, the requests as conversations)."""
    from repro_torch.core import EngineConfig, SamplingParams, ServingEngine
    from repro_torch.data.sharegpt import Conversation, Turn
    cfg = EngineConfig(mode="real", num_gpu_blocks=gpu_blocks,
                       num_cpu_blocks=gpu_blocks, max_running=n_requests,
                       max_batch=n_requests, block_size=16,
                       seed=SEED, mesh_shape=tuple(mesh)
                       ).with_policy("fastswitch")
    eng = ServingEngine(cfg, model_bundle=bundle)
    vocab = bundle["cfg"].vocab_size
    convs = []
    for h in range(n_requests):
        n = prompt_tokens[h % len(prompt_tokens)]
        t, k, p = sampling if h % 2 and sampling else (0.0, 0, 1.0)
        eng.add_request([(31 * h + 7 * i + 1) % vocab for i in range(n)],
                        SamplingParams(max_tokens=max_tokens, temperature=t,
                                       top_k=k, top_p=p), handle=h)
        convs.append(Conversation(conv_id=h, arrival_s=0.0,
                                  turns=[Turn(n, max_tokens)]))
    while eng.has_work():
        eng.step()
    eng.shutdown()
    return eng, convs


def check_sampling(eng, convs) -> dict:
    """Every request finished with its tokens; the runner stepped the
    sampled variant and counted its graphs apart from the buckets."""
    m = eng.metrics
    want = sum(c.turns[0].response_tokens for c in convs)
    if m.total_tokens != want or m.faulted or m.dropped:
        raise AssertionError(f"{m.total_tokens} tokens of {want}, faulted "
                             f"{m.faulted}, dropped {m.dropped}")
    st = eng.runner.stats
    if st.sampled_graphs <= 0:
        raise AssertionError("no sampled decode-step variant was captured")
    if st.eager_steps != st.graphs_captured + st.sampled_graphs or \
            eng.runner.graph_cache_size() != st.rebuilds:
        raise AssertionError(f"{st.eager_steps} eager steps, "
                             f"{st.graphs_captured} argmax-only and "
                             f"{st.sampled_graphs} sampled graphs, "
                             f"{st.rebuilds} buckets")
    return {"decode_steps": st.steps, "buckets": st.rebuilds,
            "argmax_only_graphs": st.graphs_captured,
            "sampled_graphs": st.sampled_graphs,
            "graph_replays": st.graph_replays}


def step_ms(eng) -> dict:
    """CUDA-event ms of one replay of each decode-step variant the runner
    holds for its last bucket, after the engine finished (its rows are
    then released: the replays write only the trash block)."""
    import torch
    out = {}
    for sampled, g in eng.runner._graphs.items():
        if g.graph is None:
            raise AssertionError("step_ms needs captured CUDA graphs")
        out["sampled" if sampled else "argmax_only"] = time_ms(
            g.graph.replay)
    torch.cuda.synchronize()
    return out


def threefry_on_card_equals_cpu(device, n_rows: int = 8,
                                vocab: int = 151936) -> int:
    """The sampler's random words of ``n_rows`` request keys folded with
    positions, made on the card and on the CPU: byte-equal, or raise.
    Returns the number of words compared."""
    import torch
    from repro_torch.models import prng
    keys = torch.stack([row_key(SEED, r) for r in range(n_rows)])
    ctx = torch.arange(n_rows, dtype=torch.int32) * 97 + 255
    words = {}
    for dev in ("cpu", device):
        folded = prng.fold_in(keys.to(dev), ctx.to(dev))
        words[str(dev)] = prng.random_bits(folded, (vocab,)).cpu()
    if not torch.equal(words["cpu"], words[str(device)]):
        raise AssertionError("threefry words on the card differ from the "
                             "CPU's")
    return words["cpu"].numel()


# ---------------------------------------------------------------------------
# phase 5d: the launcher
# ---------------------------------------------------------------------------


def run_launcher(args, out_dir: Path, timeout: float = 600.0,
                 tag: str = "") -> dict:
    """``python -m repro_torch.launch.serve ARGS --out OUT`` from the
    checkout's root (OUT named by ``tag`` where launchers run at once);
    raises on a non-zero exit.  Returns {"results": the --out JSON,
    "wall_s": the subprocess's wall seconds, "stdout": its output
    lines}."""
    import os
    out = out_dir / f"serve_{tag or len(list(out_dir.iterdir()))}.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args,
           "--out", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    return {"results": json.loads(out.read_text()), "wall_s": wall,
            "stdout": proc.stdout.splitlines()}


def serve_online(out_dir: Path, device: str = "cuda") -> dict:
    """The launcher's online smoke at full width on ``device`` (the
    reduced model on the CPU), its event log in ``out_dir``: the
    ``run_launcher`` record."""
    return run_launcher(["--online", "--real", "--smoke", "--device", device,
                         "--events", str(out_dir / "online_events.jsonl")],
                        out_dir, tag="online")


def serve_phase(out_dir: Path, device: str = "cuda",
                conversations: int = 8, online=None) -> dict:
    """The launcher's replay of ``conversations`` under both policies and
    its online smoke (``serve_online``, or its record ``online`` run
    earlier into ``out_dir``), each at full width on ``device`` (the
    reduced model on the CPU); the online event log passes
    ``validate_event_log``.  Returns what the ``serve`` line prints."""
    from repro_torch.launch.serve import validate_event_log
    replay = run_launcher(["--arch", ARCH, "--real", "--device", device,
                           "--policy", "vllm", "--policy", "fastswitch",
                           "--conversations", str(conversations)], out_dir,
                          tag="replay")
    online = online or serve_online(out_dir, device)
    n_events = validate_event_log(str(out_dir / "online_events.jsonl"))
    keep = {"total_tokens": "total_tokens", "preemptions": "preemptions",
            "callstack_wall_s": "callstack_wall_s", "ops_in": "swaps_in",
            "ops_out": "swaps_out", "blocks_in": "blocks_in",
            "blocks_out": "blocks_out",
            # the engine's simulated clock, modelled by the A10 cost model
            "p99_ttft_ms": "a10_modelled_p99_ttft_ms",
            "p99_tbt_ms": "a10_modelled_p99_tbt_ms"}
    policies = {}
    for pol, r in replay["results"].items():
        launches = r["kernel_launches"]
        if device == "cuda" and launches["paged_attention"] <= 0:
            raise AssertionError(f"serve --policy {pol}: paged attention "
                                 f"never launched: {launches}")
        policies[pol] = {**{new: r[old] for old, new in keep.items()},
                         "kernel_launches": launches}
    o = online["results"]
    return {"replay": {"wall_s": replay["wall_s"], "policies": policies,
                       "stdout": replay["stdout"]},
            "online_smoke": {"wall_s": online["wall_s"],
                             "events": n_events,
                             "total_tokens": o["total_tokens"],
                             "callstack_wall_s": o["callstack_wall_s"],
                             "kernel_launches": o["kernel_launches"],
                             "stdout": online["stdout"][-3:]}}


# ---------------------------------------------------------------------------
# phase 5e: the network front-end over two replicas
# ---------------------------------------------------------------------------

# the launcher's real-mode defaults (``run_serve``, ``run_online``)
REPLICA = dict(num_gpu_blocks=64, num_cpu_blocks=256, max_running=4,
               max_batch=4)


def session_kv(eng, handle):
    """The bytes of a parked session's CPU reuse copy (its valid prefix),
    once every in-flight copy writing them has landed.  Run it on the
    replica's thread."""
    import numpy as np
    meta = eng.reuse.export_copy(handle)
    nblk = -(-eng.reuse.valid_tokens(handle) // eng.config.block_size)
    ids = meta["block_ids"][:nblk]
    for f in eng.swap.data_deps(ids):
        f.result()
    return eng.pools.cpu[:, :, np.asarray(ids)].copy()


async def migrate_sessions(srv, vocab: int, n: int = 2) -> list:
    """Through ``srv`` (a started ``FrontendServer`` over two replicas):
    ``n`` sessions, one after the other, each submitted, parked and then
    moved by ``FrontendServer.migrate``: the first to the replica it did
    not land on, every later one to the replica the first landed on
    (where it landed there, it stays), so each replica swaps a moved
    session in.  Before a session's
    follow-up, its shipped KV must equal the bytes the target installed.
    Returns, per session, its replicas, whether it moved (its KV then
    arrived byte-equal), the valid tokens shipped and its turns (prompt,
    streamed tokens)."""
    import asyncio
    import numpy as np
    from repro_torch.data.sharegpt import synth_prompt_ids
    reader, writer = await asyncio.open_connection(srv.host, srv.port)

    async def turn(msg):
        writer.write(json.dumps(msg).encode() + b"\n")
        await writer.drain()
        evs = []
        while not evs or evs[-1]["event"] not in ("finish", "error"):
            evs.append(json.loads(await asyncio.wait_for(reader.readline(),
                                                          600)))
        if evs[-1]["event"] == "error":
            raise AssertionError(f"front-end refused {msg}: {evs[-1]}")
        acc = next(e for e in evs if e["event"] == "accepted")
        return acc, [t for e in evs if e["event"] == "token"
                     for t in e["token_ids"]]

    moved, first_src = [], None
    for i in range(n):
        p0 = synth_prompt_ids(900 + i, 0, 40, vocab)
        p1 = synth_prompt_ids(900 + i, 1, 12, vocab)
        acc, t0 = await turn({"op": "submit", "client": "migrant",
                              "prompt": p0, "max_tokens": 8})
        h, src = acc["handle"], acc["replica"]
        if first_src is None:
            first_src, home = src, 1 - src
        else:
            home = first_src
        payload = await srv.migrate(h, home)
        if payload is None and src != home:
            raise AssertionError(f"session {h}: the move {src} -> {home} "
                                 "was refused")
        valid = 0
        if payload is not None:
            dst = srv.replicas[home]
            got = await asyncio.wrap_future(dst.call(session_kv, dst.engine,
                                                     h))
            valid = payload["valid_tokens"]
            if valid <= 0 or not np.array_equal(got, payload["kv"]):
                raise AssertionError(f"session {h}: the KV installed on "
                                     f"replica {home} differs from the "
                                     "bytes shipped")
        acc1, t1 = await turn({"op": "continue", "handle": h, "prompt": p1,
                               "max_tokens": 8})
        if acc1["replica"] != home:
            raise AssertionError(f"session {h}: its follow-up went to "
                                 f"replica {acc1['replica']}, not {home}")
        writer.write(json.dumps({"op": "release",
                                 "handle": h}).encode() + b"\n")
        await writer.drain()
        moved.append({"handle": h, "from": src, "to": home,
                      "moved": payload is not None, "valid_tokens": valid,
                      "turns": [(p0, t0), (p1, t1)]})
    writer.close()
    await writer.wait_closed()
    return moved


def stream_checks(bundle, sessions) -> dict:
    """Each session's streamed tokens (a list of (prompt, tokens) turns)
    against the plain dense forward of its history."""
    out = {"sessions": 0, "generated": 0, "equal": 0, "near_ties": 0,
           "max_gap": 0.0}
    for turns in sessions:
        hist, generated = [], []
        for prompt, tokens in turns:
            hist += list(prompt)
            generated += range(len(hist), len(hist) + len(tokens))
            hist += list(tokens)
        r = check_history(bundle, hist, generated)
        out["sessions"] += 1
        for k in ("generated", "equal", "near_ties"):
            out[k] += r[k]
        out["max_gap"] = max(out["max_gap"], r["max_gap"])
    return out


def frontend_phase(bundle, out_dir: Path) -> dict:
    """``FrontendServer`` over two real replicas sharing ``bundle``, each
    with a pool of the launcher's default size, on 127.0.0.1, port 0: the
    loopback smoke's clients (submit, stream, follow-up, abort) with
    token-id prompts, then two sessions moved between the replicas
    (``migrate_sessions``), then a drain.  Every replica's event log is
    well-formed, the affinity audit finds no violation, every streamed
    token is the dense argmax or a near-tie, and paged attention and both
    run copies ran on each replica's pool (launch counts set to 0 just
    before)."""
    from repro_torch.core import EngineConfig, ServingEngine
    from repro_torch.frontend import loadgen
    from repro_torch.kernels import launches
    from repro_torch.launch.serve import _serving_kernels
    engines = []

    def make_engines(mk_sink):
        cfg = EngineConfig(mode="real", seed=SEED,
                           **REPLICA).with_policy("fastswitch")
        engines.extend(ServingEngine(cfg, model_bundle=bundle,
                                     event_sink=mk_sink(i),
                                     stream_tokens=True) for i in range(2))
        return engines

    def after(srv):
        return migrate_sessions(srv, bundle["cfg"].vocab_size)

    kernels = _serving_kernels()
    launches.reset(*kernels.values())
    t0 = time.perf_counter()
    res = loadgen.run_smoke(str(out_dir / "frontend"), make_engines,
                            vocab=bundle["cfg"].vocab_size, after=after)
    for eng in engines:
        eng.shutdown()             # the last swap-outs' copies land
    wall = time.perf_counter() - t0
    per_replica = [{name: launches.on(fn, eng.pools.gpu)
                    for name, fn in kernels.items()} for eng in engines]
    total = {name: fn.launches for name, fn in kernels.items()}
    swaps = [{d: eng.swap.ops_by_dir[d] for d in ("in", "out")}
             for eng in engines]
    if any(min(s.values()) <= 0 for s in swaps):
        raise AssertionError(f"a replica swapped no KV one way: {swaps}")
    if bundle["params"]["embed"]["table"].is_cuda:
        if any(min(c.values()) <= 0 for c in per_replica):
            raise AssertionError(f"a kernel never launched on a replica's "
                                 f"pool: {per_replica}")
        if {n: sum(c[n] for c in per_replica) for n in total} != total:
            raise AssertionError(f"launches per replica {per_replica} do "
                                 f"not sum to the process's {total}")
    sessions = [[(t["prompt"], t["tokens"]) for t in turns]
                for c in res["clients"] for turns in c["turns"].values()]
    moved = res["after"]
    tokens = stream_checks(bundle, sessions + [m["turns"] for m in moved])
    for m in moved:
        del m["turns"]
    return {"wall_s": wall, "replicas": res["replicas"],
            "turns_finished": res["turns_finished"],
            "affinity_violations": res["affinity_violations"],
            "events_validated": len(res["events_validated"]),
            "migrations": moved, "launches_per_replica": per_replica,
            "launches": total, "launch_count": "per replica (each pool) "
            "and their sum over the process", "swap_ops_per_replica": swaps,
            "tokens": tokens}


def serve_one_session(argv, prompt, timeout: float = 600.0) -> dict:
    """Boot ``python -m repro_torch.launch.serve --serve --port 0 ARGV``
    from the checkout's root, send one session of ``prompt`` (token ids)
    over a socket, read its events to the ``finish``, then interrupt the
    server while the client is still connected.  Returns the events, the
    server's output lines, its exit code and stderr, and the wall
    seconds."""
    import os
    import re
    import signal
    import socket
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--serve",
         "--port", "0", *argv], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        first = proc.stdout.readline().strip()
        m = re.match(r"frontend: .* on (\S+):(\d+)$", first)
        if not m:
            proc.kill()
            raise AssertionError(f"the front-end did not start: {first!r} "
                                 f"{proc.communicate()[1][-2000:]}")
        events = []
        with socket.create_connection((m[1], int(m[2])),
                                      timeout=timeout) as sock, \
                sock.makefile("rw") as f:
            f.write(json.dumps({"op": "submit", "id": "s0", "client": "t",
                                "prompt": prompt, "max_tokens": 4}) + "\n")
            f.flush()
            while not events or events[-1].get("event") not in (
                    "finish", "error"):
                line = f.readline()
                if not line:
                    raise AssertionError(f"the front-end closed the "
                                         f"connection after {events}")
                events.append(json.loads(line))
            proc.send_signal(signal.SIGINT)
            out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"events": events, "stdout": [first, *out.splitlines()],
            "returncode": proc.returncode, "stderr": err,
            "wall_s": time.perf_counter() - t0}


def serve_frontend_phase(device: str = "cuda") -> dict:
    """The launcher's ``--serve --router 2 --real`` on ``device`` as a
    subprocess: one session finishes by length with its 4 tokens, and an
    interrupt stops the server with exit code 0."""
    run = serve_one_session(["--router", "2", "--real", "--device", device,
                             "--stream"], list(range(3, 67)))
    last = run["events"][-1]
    tokens = [t for e in run["events"] if e["event"] == "token"
              for t in e["token_ids"]]
    if run["returncode"] != 0 or last.get("reason") != "length" \
            or len(tokens) != 4:
        raise AssertionError(f"serve --router 2: exit {run['returncode']}, "
                             f"events {run['events']}, "
                             f"stderr {run['stderr'][-2000:]}")
    return {"wall_s": run["wall_s"], "tokens": len(tokens),
            "finish": last["reason"], "stdout": run["stdout"]}


# ---------------------------------------------------------------------------
# phase 5f: the prefix cache
# ---------------------------------------------------------------------------


def prefix_phase(bundle, out_dir: Path, device: str = "cuda") -> dict:
    """The launcher's ``--online --real --prefix-cache --smoke`` on
    ``device`` (hits, tokens saved and the C1/C2 sanitizer on every step
    are its own asserts; its event log must be well-formed), and the same
    run with the cache off (``--system-prompt``: the same shared system
    prompt opens each conversation): every conversation's greedy tokens
    equal, or
    the first difference a near-tie under the dense forward of
    ``bundle`` (the launcher's weights: the same seed)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.launch.serve import validate_event_log
    events = out_dir / "prefix_events.jsonl"
    args = ["--online", "--real", "--smoke", "--device", device]
    # the two launchers at once: each is a subprocess, mostly its start-up
    with ThreadPoolExecutor(2) as pool:
        on = pool.submit(run_launcher, [*args, "--prefix-cache", "--events",
                                        str(events)], out_dir, tag="on")
        off = pool.submit(run_launcher, [*args, "--system-prompt"], out_dir,
                          tag="off")
        on, off = on.result(), off.result()
    r = on["results"]
    if not (r["prefix_hits"] > 0 and r["prefix_tokens_saved"] > 0
            and r["invariant_checks"] > 0):
        raise AssertionError(f"prefix smoke: hits {r['prefix_hits']}, "
                             f"saved {r['prefix_tokens_saved']}, sanitizer "
                             f"checks {r['invariant_checks']}")
    launched = r["kernel_launches"]
    if device == "cuda" and min(launched.values()) <= 0:
        raise AssertionError(f"prefix smoke: a kernel never launched: "
                             f"{launched}")
    h_on = r["token_histories"]
    h_off = off["results"]["token_histories"]
    common = sorted(set(h_on) & set(h_off), key=int)
    if not common:
        raise AssertionError("no conversation finished a turn in both runs")
    equal, ties = 0, []
    for c in common:
        d = first_divergence(bundle, h_on[c], h_off[c])
        if d is None:
            equal += 1
        elif d[1] >= NEAR_TIE:
            raise AssertionError(f"conversation {c}: cache on and off "
                                 f"differ at {d[0]} with gap {d[1]}")
        else:
            ties.append({"conv": int(c), "position": d[0], "gap": d[1]})
    return {"wall_s": on["wall_s"], "off_wall_s": off["wall_s"],
            "events": validate_event_log(str(events)),
            "prefix": r["prefix"], "prefix_hits": r["prefix_hits"],
            "prefix_tokens_saved": r["prefix_tokens_saved"],
            "invariant_checks": r["invariant_checks"],
            "kernel_launches": launched,
            "off_kernel_launches": off["results"]["kernel_launches"],
            "total_tokens": r["total_tokens"],
            "off_total_tokens": off["results"]["total_tokens"],
            "conversations_compared": len(common),
            "conversations_equal": equal, "near_ties": ties,
            "tolerance": NEAR_TIE, "callstack_wall_s": r["callstack_wall_s"],
            "stdout": on["stdout"][-4:]}


# ---------------------------------------------------------------------------
# phase 5m: the control plane on the card: faults, aborts, stop tokens
# ---------------------------------------------------------------------------

CONTROL_FINISHES = ("length", "stop", "error", "shed")
CONTROL_WATCHDOG_US = 100_000.0
# the survivors' and stop runs' prompts and budgets (the real cases of
# tests/test_chaos.py and tests/test_abort_properties.py)
CONTROL_PROMPT = 12
CONTROL_TOKENS = 10


def control_engine(bundle, sizes: dict, policy: str = "fastswitch",
                   events=None, chunk: int = 0, stream: bool = False,
                   **cfg_kw):
    """A real-mode ``ServingEngine`` over ``bundle`` with the pool of
    ``sizes`` (the engine phase's), ``policy`` (with chunked prefill of
    ``chunk`` tokens when > 0), a still priority trace, and the
    ``EngineConfig`` overrides ``cfg_kw``; ``events`` takes each event."""
    from dataclasses import replace

    from repro_torch.core import EngineConfig, ServingEngine
    from repro_torch.data.priority import PriorityTrace
    cfg = EngineConfig(mode="real", num_gpu_blocks=sizes["gpu_blocks"],
                       num_cpu_blocks=sizes["cpu_blocks"],
                       max_running=sizes["max_running"],
                       max_batch=sizes["max_running"], block_size=16,
                       seed=SEED, **cfg_kw).with_policy(policy)
    if chunk:
        cfg = replace(cfg, policy=replace(cfg.policy,
                                          chunked_prefill_tokens=chunk))
    return ServingEngine(cfg, trace=PriorityTrace("random", 1e-9, seed=0),
                         model_bundle=bundle, event_sink=events,
                         stream_tokens=stream)


def control_ids(bundle, n: int, seed: int) -> list:
    """``n`` prompt ids drawn from ``seed`` (the tests' ``_ids``)."""
    import numpy as np
    return np.random.RandomState(seed).randint(
        1, bundle["cfg"].vocab_size, size=n).tolist()


def drain_engine(eng, max_iters: int = 4000) -> list:
    """Step ``eng`` until it has no work; its outputs."""
    outs, it = [], 0
    while eng.has_work() and it < max_iters:
        outs += eng.step()
        it += 1
    if eng.has_work():
        raise AssertionError(f"the engine did not drain in {max_iters} "
                             "steps")
    return outs


def serve_conversations(eng, convs, max_iters: int = 20_000) -> list:
    """An open-world client: every conversation's first turn submitted at
    its arrival, each later turn its think time after the previous one
    finished by length or stop (``synth_prompt_ids`` prompts, as the
    replay client sends them).  Returns every output."""
    from repro_torch.core import SamplingParams
    from repro_torch.data.sharegpt import prompt_for_turn
    vocab = eng.model_bundle["cfg"].vocab_size
    by_handle = {c.conv_id: c for c in convs}
    pending = sorted(convs, key=lambda c: c.arrival_s)
    sleeping, outs, it = [], [], 0
    while (pending or sleeping or eng.has_work()) and it < max_iters:
        now_s = eng.clock.now_us / 1e6
        while pending and pending[0].arrival_s <= now_s:
            conv = pending.pop(0)
            eng.add_request(prompt_for_turn(conv, 0, vocab),
                            SamplingParams(
                                max_tokens=conv.turns[0].response_tokens),
                            handle=conv.conv_id,
                            retain_kv=len(conv.turns) > 1)
        for entry in list(sleeping):
            if entry[0] <= now_s:
                sleeping.remove(entry)
                _, conv, tix = entry
                eng.continue_session(
                    conv.conv_id, prompt_for_turn(conv, tix, vocab),
                    SamplingParams(
                        max_tokens=conv.turns[tix].response_tokens),
                    retain_kv=tix + 1 < len(conv.turns))
        wake = [w[0] * 1e6 for w in sleeping]
        if pending:
            wake.append(pending[0].arrival_s * 1e6)
        step = eng.step(until_us=min(wake) if wake else None)
        outs += step
        for out in step:
            conv = by_handle[out.handle]
            if out.finished and out.finish_reason in ("length", "stop") \
                    and out.turn + 1 < len(conv.turns):
                sleeping.append((out.t_us / 1e6 + conv.think_time_s, conv,
                                 out.turn + 1))
        it += 1
    if pending or sleeping or eng.has_work():
        raise AssertionError(f"the client did not finish in {max_iters} "
                             "steps")
    return outs


def check_row_clean(eng, rid: int, row) -> None:
    """The runner row ``row`` that ``rid`` held is back on the trash
    sentinel: unregistered, every page the trash block, context 0,
    masked off (nothing to check for a request that held no row)."""
    runner = eng.runner
    if rid in runner._rows or rid in runner._prefills:
        raise AssertionError(f"request {rid} still holds runner state")
    if row is None:
        return
    bt = runner._bt[row].cpu()
    if not bool((bt == eng._trash_block).all()):
        raise AssertionError(f"freed row {row} still maps blocks "
                             f"{bt.tolist()}")
    if int(runner._ctx[row]) != 0 or bool(runner._active[row]):
        raise AssertionError(f"freed row {row}: context "
                             f"{int(runner._ctx[row])}, active "
                             f"{bool(runner._active[row])}")


def check_reclaimed(eng) -> None:
    """Nothing leaked once no request is live: every swap task retired
    (the clock run past them), every GPU and CPU block free, no failed
    task left for a live request, the pool managers' invariants, and
    every runner row unregistered and masked off, with no prefill carry
    left."""
    from repro_torch.core import check_engine_invariants
    eng.clock.advance(1e9)
    eng.swap.synchronize(eng.clock, list(eng.swap.ongoing_swap_in)
                         + list(eng.swap.ongoing_swap_out))
    eng.swap.poll_completed(eng.clock)
    check_engine_invariants(eng)
    gpu, cpu = eng.gpu_mgr, eng.reuse.mgr
    if gpu.free_blocks() != gpu.num_blocks or \
            cpu.free_blocks() != cpu.num_blocks:
        raise AssertionError(f"leaked blocks: GPU {gpu.free_blocks()} of "
                             f"{gpu.num_blocks} free, CPU "
                             f"{cpu.free_blocks()} of {cpu.num_blocks}")
    if eng.swap.ongoing_swap_in or eng.swap.ongoing_swap_out:
        raise AssertionError("a swap task was stranded")
    for t in eng.swap.take_failed():
        if t.req_id in eng.sched.requests:
            raise AssertionError(f"a failed swap task of live request "
                                 f"{t.req_id} was never processed")
    gpu.check_invariants()
    cpu.check_invariants()
    runner = eng.runner
    if runner._rows or runner._prefills:
        raise AssertionError(f"runner rows {runner._rows} and prefills "
                             f"{sorted(runner._prefills)} left")
    if runner._active is not None and bool(runner._active.any()):
        raise AssertionError("a runner row is still active")


def held_tokens(bundle, got, want, start: int, what: str) -> dict:
    """``got`` (a token history whose first ``start`` tokens are the
    prompt) against ``want`` (the same request's in a fault-free run):
    equal, or first different where the dense forward of the shared
    prefix puts the two tokens within ``NEAR_TIE``.  Returns the
    generated tokens compared, how many are equal before any difference,
    and the near-tie."""
    d = first_divergence(bundle, got, want)
    if d is None:
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} tokens, the "
                                 f"fault-free run {len(want)}")
        return {"generated": len(got) - start, "equal": len(got) - start,
                "near_tie": None}
    if d[1] >= NEAR_TIE:
        raise AssertionError(f"{what}: differs from the fault-free run at "
                             f"{d[0]} with gap {d[1]} (>= {NEAR_TIE})")
    return {"generated": len(got) - start, "equal": d[0] - start,
            "near_tie": {"position": d[0], "gap": d[1]}}


def control_chaos(bundle, convs, sizes: dict, events_path: Path) -> dict:
    """The engine workload under ``FaultPlan.chaos(seed=0, intensity=1.0)``
    with the sanitizer after every step and the copy watchdog on, through
    an open-world client: at least three fault kinds fire, ``step()``
    never raises, every request ends as length, stop, error or shed,
    nothing leaks, the event log is well-formed, and every turn that
    finished by length has greedy tokens the dense argmax or a near-tie
    (``check_history``)."""
    from repro_torch.core import FaultPlan
    from repro_torch.launch.serve import validate_event_log
    with open(events_path, "w") as f:
        eng = control_engine(
            bundle, sizes, events=lambda ev: f.write(
                json.dumps(ev.as_dict()) + "\n"),
            fault_plan=FaultPlan.chaos(seed=0, intensity=1.0),
            check_invariants_every=1, swap_watchdog_us=CONTROL_WATCHDOG_US)
        outs = serve_conversations(eng, convs)
        eng.shutdown()
    fired = dict(eng.faults.fired)
    kinds = sorted(k for k, n in fired.items() if n > 0)
    if len(kinds) < 3:
        raise AssertionError(f"chaos fired {fired}: fewer than 3 kinds")
    m = eng.metrics
    if m.invariant_checks <= 0:
        raise AssertionError("the sanitizer never ran")
    finished = {}
    for o in outs:
        if o.finished:
            finished[(o.handle, o.turn)] = o.finish_reason
    bad = {k: r for k, r in finished.items() if r not in CONTROL_FINISHES}
    if bad:
        raise AssertionError(f"requests ended as {bad}")
    last = {}
    for (h, t), r in sorted(finished.items()):
        last[h] = r
    if set(last) != {c.conv_id for c in convs}:
        raise AssertionError(f"conversations {sorted(last)} ended, of "
                             f"{[c.conv_id for c in convs]}")
    check_reclaimed(eng)
    n_events = validate_event_log(str(events_path))
    rows = []
    for c in convs:
        hist = eng._token_hist_by_conv.get(c.conv_id, [])
        generated, pos = [], 0
        for tix, turn in enumerate(c.turns):
            pos += turn.prompt_tokens
            if finished.get((c.conv_id, tix)) == "length":
                generated.extend(range(pos, pos + turn.response_tokens))
            pos += turn.response_tokens
        if generated:
            rows.append({"conv": c.conv_id,
                         **check_history(bundle, hist, generated)})
    if not rows:
        raise AssertionError("no turn finished by length under chaos")
    reasons = {}
    for r in finished.values():
        reasons[r] = reasons.get(r, 0) + 1
    return {"faults_fired": fired, "fault_kinds": kinds,
            "copy_retries": eng.swap.n_retries,
            "copy_failures": eng.swap.n_copy_failures,
            "watchdog_rescues": eng.swap.n_watchdog,
            "recompute_resumes": m.swap_failure_resumes,
            "faulted": m.faulted, "shed": m.shed,
            "preemptions": m.preemptions,
            "invariant_checks": m.invariant_checks,
            "turns_by_finish": reasons, "events": n_events,
            "fenced_swap_ins": eng.pools.fenced_swap_ins,
            "tokens_checked": sum(r["generated"] for r in rows),
            "tokens_equal": sum(r["equal"] for r in rows),
            "near_ties": sum(r["near_ties"] for r in rows),
            "max_gap": max(r["max_gap"] for r in rows)}


def control_containment(bundle, sizes: dict) -> dict:
    """The real cases of tests/test_chaos.py at full width: a poisoned
    request beside a survivor, and a permanent swap-out fault after a
    forced preempt (the request resumes by recompute); and its stalled
    copy rescued by the watchdog (the copy forced synchronously); each
    request's tokens held against a fault-free run (``held_tokens``)."""
    from repro_torch.core import FaultInjector, FaultPlan, SamplingParams

    def pair(plan):
        eng = control_engine(bundle, sizes, fault_plan=plan,
                             check_invariants_every=2)
        hs = [eng.add_request(control_ids(bundle, CONTROL_PROMPT, s),
                              SamplingParams(max_tokens=CONTROL_TOKENS))
              for s in (1, 2)]
        outs = drain_engine(eng)
        eng.shutdown()
        check_reclaimed(eng)
        return hs, {o.handle: o for o in outs if o.finished}, \
            {h: list(eng._token_hist_by_conv.get(h, [])) for h in hs}

    hs, base_by, base = pair(None)
    plan = FaultPlan(seed=5, p_poison=0.5)
    inj = FaultInjector(plan)
    if inj.poisoned(hs[0]) == inj.poisoned(hs[1]):
        raise AssertionError("the poison seed does not separate the two "
                             "requests")
    hs2, by, hist = pair(plan)
    poisoned = hs2[0] if inj.poisoned(hs2[0]) else hs2[1]
    survivor = hs2[1] if poisoned == hs2[0] else hs2[0]
    if by[poisoned].finish_reason != "error" or \
            by[survivor].finish_reason != "length":
        raise AssertionError(f"poison: finishes {by[poisoned].finish_reason}"
                             f" / {by[survivor].finish_reason}")
    poison = held_tokens(bundle, hist[survivor], base[survivor],
                         CONTROL_PROMPT, "the poison survivor")

    def single(plan):
        eng = control_engine(bundle, sizes, fault_plan=plan,
                             check_invariants_every=2)
        h = eng.add_request(control_ids(bundle, CONTROL_PROMPT, 3),
                            SamplingParams(max_tokens=12))
        for _ in range(2):
            eng.step()
        eng._preempt(h)
        outs = drain_engine(eng)
        eng.shutdown()
        check_reclaimed(eng)
        fin = [o for o in outs if o.handle == h and o.finished]
        return (fin[-1].finish_reason, list(eng._token_hist_by_conv[h]),
                eng.metrics.swap_failure_resumes)

    _, want, _ = single(None)
    reason, got, resumes = single(FaultPlan(seed=0, p_swap_permanent=1.0))
    if reason != "length" or resumes < 1:
        raise AssertionError(f"permanent swap-out fault: {reason}, "
                             f"{resumes} recompute resumes")

    def stalled(plan):
        eng = control_engine(bundle, sizes, fault_plan=plan,
                             swap_watchdog_us=60_000.0,
                             check_invariants_every=1)
        eng.swap.adaptive = False                 # force async dispatch
        h = eng.add_request(control_ids(bundle, 40, 6),
                            SamplingParams(max_tokens=30))
        # a second request keeps the engine decoding (its clock moving in
        # iteration-sized steps) while h's copies sit stalled
        eng.add_request(control_ids(bundle, 24, 7),
                        SamplingParams(max_tokens=200))
        eng.step()
        eng._preempt(h)
        outs = drain_engine(eng)
        eng.shutdown()
        check_reclaimed(eng)
        fin = [o for o in outs if o.handle == h and o.finished]
        return (fin[-1].finish_reason, list(eng._token_hist_by_conv[h]),
                eng.swap.n_watchdog)

    _, want_w, _ = stalled(None)
    w_reason, got_w, rescues = stalled(
        FaultPlan(seed=0, p_swap_stall=1.0, stall_us=5_000_000.0))
    if w_reason != "length" or rescues < 1:
        raise AssertionError(f"stalled copies: {w_reason}, {rescues} "
                             "watchdog rescues")
    return {"poison": poison, "permanent_swap_out": {
        **held_tokens(bundle, got, want, CONTROL_PROMPT,
                      "the recompute resume"),
        "recompute_resumes": resumes},
        "stalled_swap": {**held_tokens(bundle, got_w, want_w, 40,
                                       "the watchdog's rescue"),
                         "watchdog_rescues": rescues}}


def control_aborts(bundle, sizes: dict) -> dict:
    """At full width, one request aborted in each lifecycle state of
    tests/test_abort_properties.py's matrix, beside a survivor: after the
    abort the sanitizer passes, the request's runner row is back on the
    trash sentinel, and once drained nothing leaks; each survivor's
    tokens held against the survivor alone (``held_tokens``); after the
    mid-swap-in abort a new request takes the freed blocks and decodes
    the dense argmax or a near-tie.  Returns per state the survivor's
    counts, and the swap-ins fenced by a release event in all."""
    from repro_torch.core import SamplingParams, check_engine_invariants
    from repro_torch.core.scheduler import ReqState
    sp = SamplingParams(max_tokens=CONTROL_TOKENS)
    survivor_ids = control_ids(bundle, CONTROL_PROMPT, 2)
    alone = control_engine(bundle, sizes)
    h = alone.add_request(survivor_ids, sp)
    drain_engine(alone)
    alone.shutdown()
    want = list(alone._token_hist_by_conv[h])
    del alone

    def waiting(eng, h):
        return eng._req(h).state == ReqState.WAITING

    def running(eng, h):
        for _ in range(4):
            eng.step()
        return eng._req(h).state == ReqState.RUNNING

    def mid_prefill(eng, h):
        eng.step()
        return eng._req(h).prefill_remaining > 0 and h in eng.runner._prefills

    def swapped(eng, h):
        eng.step()
        eng._preempt(h)
        return eng._req(h).state == ReqState.SWAPPED \
            and eng.reuse.valid_tokens(h) > 0

    def swapping_in(eng, h):
        eng.swap.adaptive = False                 # force async
        for _ in range(3):
            eng.step()
        eng._preempt(h)
        return eng._swap_in(h) is False and sum(
            t.req_id == h for t in eng.swap.ongoing_swap_in) > 1

    def recompute_waiting(eng, h):
        eng.step()
        eng._preempt(h)
        req = eng._req(h)
        return req.state == ReqState.WAITING and req.resume_tokens > 0

    def finished_retained(eng, h):
        drain_engine(eng)
        return h in eng.parked and eng.reuse.valid_tokens(h) > 0

    cases = {
        # state: (setup, policy, chunked prefill, engine overrides,
        #         victim prompt tokens, victim budget, retain)
        "waiting": (waiting, "fastswitch", 0, {}, 8, 40, False),
        "mid_chunked_prefill": (mid_prefill, "fastswitch", 16, {}, 80, 4,
                                False),
        "running": (running, "fastswitch", 0, {}, 10, 30, False),
        "swapped": (swapped, "fastswitch", 0, {}, 8, 40, False),
        "swapping_in": (swapping_in, "fastswitch", 0,
                        {"swap_chunk_blocks": 1}, 40, 30, False),
        "recompute_waiting": (recompute_waiting, "vllm-recompute", 0, {},
                              8, 40, False),
        "finished_retained": (finished_retained, "fastswitch", 0, {}, 8, 3,
                              True),
    }
    out, fenced = {}, 0
    for state, (setup, policy, chunk, kw, n, budget, retain) in \
            cases.items():
        eng = control_engine(bundle, sizes, policy=policy, chunk=chunk, **kw)
        victim = eng.add_request(control_ids(bundle, n, 4),
                                 SamplingParams(max_tokens=budget),
                                 retain_kv=retain)
        survivor = eng.add_request(survivor_ids, sp)
        if not setup(eng, victim):
            raise AssertionError(f"abort in {state}: the scenario never "
                                 "reached the state")
        row = eng.runner._rows.get(victim)
        if not eng.abort(victim):
            raise AssertionError(f"abort in {state} returned False")
        check_engine_invariants(eng)
        check_row_clean(eng, victim, row)
        rec = {"had_row": row is not None}
        if state == "swapping_in":
            # a new request takes the freed blocks over
            ids = control_ids(bundle, CONTROL_PROMPT, 5)
            succ = eng.add_request(ids, SamplingParams(max_tokens=6))
        drain_engine(eng)
        eng.shutdown()
        check_reclaimed(eng)
        rec["survivor"] = held_tokens(
            bundle, list(eng._token_hist_by_conv[survivor]), want,
            CONTROL_PROMPT, f"the survivor of an abort in {state}")
        if state == "swapping_in":
            hist = list(eng._token_hist_by_conv[succ])
            rec["successor"] = check_history(
                bundle, hist, list(range(len(ids), len(hist))))
            if rec["successor"]["generated"] != 6:
                raise AssertionError(f"the successor decoded "
                                     f"{rec['successor']['generated']} "
                                     "tokens, not 6")
        if eng.metrics.aborted != 1:
            raise AssertionError(f"abort in {state}: {eng.metrics.aborted} "
                                 "aborts counted")
        fenced += eng.pools.fenced_swap_ins
        out[state] = rec
        del eng
    return {"by_state": out, "fenced_swap_ins": fenced}


def control_stop(bundle, sizes: dict, prompt_tokens: int = 256,
                 budget: int = 32) -> dict:
    """A stop token placed mid-stream: of the stop-free run's tokens, the
    last to appear for the first time before the final one (random
    weights repeat tokens) becomes the stop set; the turn ends as stop,
    its streamed tokens byte-equal to the stop-free run's up to and
    including it."""
    from repro_torch.core import SamplingParams
    from repro_torch.data.sharegpt import synth_prompt_ids
    prompt = synth_prompt_ids(0, 0, prompt_tokens, bundle["cfg"].vocab_size)

    def run(stop):
        eng = control_engine(bundle, sizes, stream=True)
        eng.add_request(prompt, SamplingParams(max_tokens=budget,
                                               stop_token_ids=stop))
        outs = drain_engine(eng)
        eng.shutdown()
        check_reclaimed(eng)
        fin = [o for o in outs if o.finished]
        return [t for o in outs if o.token_ids for t in o.token_ids], fin

    free, fin = run(())
    if len(free) != budget or fin[0].finish_reason != "length":
        raise AssertionError(f"stop-free run: {len(free)} tokens, "
                             f"{fin[0].finish_reason}")
    firsts = [i for i in range(1, budget - 1) if free[i] not in free[:i]]
    if not firsts:
        raise AssertionError(f"stop-free run {free}: no token first "
                             "appears mid-stream")
    cut = firsts[-1]
    stop = free[cut]
    got, fin = run((stop,))
    if fin[0].finish_reason != "stop" or got != free[:cut + 1] or \
            fin[0].generated != cut + 1:
        raise AssertionError(f"stop token {stop}: {fin[0].finish_reason}, "
                             f"{len(got)} tokens, the stop-free prefix "
                             f"{cut + 1}; equal {got == free[:cut + 1]}")
    return {"stop_token": stop, "stop_at": cut, "tokens": len(got),
            "byte_equal_prefix": True}


def control_phase(bundle, convs, sizes: dict, out_dir: Path) -> dict:
    """The control plane's fault, abort and stop paths on ``bundle``'s
    device (``control_chaos``, ``control_containment``, ``control_aborts``,
    ``control_stop``), with the serving kernels' launch counts set to 0
    just before; on CUDA each must have launched."""
    from repro_torch.kernels import block_copy as bc
    from repro_torch.kernels import paged_attention as pa
    kernels = {"paged_attention": pa.paged_attention,
               "block_gather_runs": bc.block_gather_runs,
               "block_scatter_runs": bc.block_scatter_runs}
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = {"chaos": control_chaos(bundle, convs, sizes,
                                  out_dir / "control_events.jsonl"),
           "containment": control_containment(bundle, sizes),
           "aborts": control_aborts(bundle, sizes),
           "stop": control_stop(bundle, sizes)}
    res["seconds"] = time.perf_counter() - t0
    res["launches"] = {name: k.launches for name, k in kernels.items()}
    if bundle["params"]["embed"]["table"].is_cuda and \
            min(res["launches"].values()) <= 0:
        raise AssertionError(f"control: a kernel never launched: "
                             f"{res['launches']}")
    res["fenced_swap_ins"] = (res["chaos"]["fenced_swap_ins"]
                              + res["aborts"]["fenced_swap_ins"])
    return res


# ---------------------------------------------------------------------------
# phase 5n: KV reuse under a short CPU pool: contaminated copies
# ---------------------------------------------------------------------------

# the engine phase's workload with a host pool this many blocks long: both
# sizes contaminate copies, and swap some requests back in over a copy
# shorter than their context
REUSE_CPU_BLOCKS = (256, 192)


def watch_swap_ins(core) -> dict:
    """Record the swap-ins of ``core``, a ``ServingEngine`` of either
    package: each ``_swap_in`` call as (request, context tokens, valid
    tokens of its CPU copy), and each swap-in dispatch as (request, first
    and end position of the blocks it restores, the copy's valid tokens,
    the positions holding KV, ``context_tokens - 1``).  A copy's valid
    tokens are capped by the CPU blocks it holds, as the port's
    ``reuse.restorable_tokens``.  Returns the two lists, filled as the
    engine runs."""
    seen = {"swap_ins": [], "restores": []}
    real_in, real_dispatch = core._swap_in, core._dispatch_swap
    bs = core.config.block_size

    def valid(rid):
        c = core.reuse.copies.get(rid)
        return min(c.valid_tokens, core.reuse.mgr.request_tokens(rid)) \
            if c is not None else 0

    def swap_in(rid):
        seen["swap_ins"].append((rid, core._req(rid).context_tokens,
                                 valid(rid)))
        return real_in(rid)

    def dispatch(rid, direction, gpu_runs, *a, **k):
        if direction == "in" and gpu_runs:
            first = core._block_table(rid).index(gpu_runs[0][0])
            n = sum(n for _, n in gpu_runs)
            seen["restores"].append(
                (rid, first * bs, (first + n) * bs, valid(rid),
                 core._req(rid).context_tokens - 1))
        return real_dispatch(rid, direction, gpu_runs, *a, **k)
    core._swap_in, core._dispatch_swap = swap_in, dispatch
    return seen


def past_valid_prefix(restores, block_size: int = 16) -> list:
    """The restores (``watch_swap_ins``) that copy a block starting at or
    past their copy's valid prefix and before the positions holding KV
    end: stale KV the engine would attend."""
    def ceil(n):
        return -(-n // block_size) * block_size
    return [r for r in restores
            if max(r[1], ceil(r[3])) < min(r[2], r[4])]


def short_swap_ins(swap_ins) -> list:
    """The swap-ins (``watch_swap_ins``) of a request whose CPU copy is
    valid for fewer positions than hold its KV."""
    return [s for s in swap_ins if s[2] < s[1] - 1]


def reuse_phase(bundle, convs, sizes: dict,
                cpu_blocks=REUSE_CPU_BLOCKS) -> dict:
    """The engine phase's workload on ``bundle`` with each host pool of
    ``cpu_blocks`` blocks (the other ``sizes`` as given), the serving
    kernels' launch counts set to 0 just before each run.  Each run must
    finish every turn, restore no block past a copy's valid prefix, meet
    at least one short copy and resume it (``short_copy_resumes``), serve
    every greedy token as the dense argmax or a near-tie, and, on CUDA,
    launch each serving kernel.  Returns one record per size."""
    from repro_torch.kernels import block_copy as bc
    from repro_torch.kernels import launches
    from repro_torch.kernels import paged_attention as pa
    kernels = {"paged_attention": pa.paged_attention,
               "block_gather_runs": bc.block_gather_runs,
               "block_scatter_runs": bc.block_scatter_runs}
    out = {}
    for n_cpu in cpu_blocks:
        seen = {}
        launches.reset(*kernels.values())
        eng, wall, _, swaps = run_engine(
            bundle, convs, **dict(sizes, cpu_blocks=n_cpu),
            on_engine=lambda e: seen.update(watch_swap_ins(e.core)))
        launched = {k: w.launches for k, w in kernels.items()}
        checked = check_engine(eng, convs, swaps, every_conv_swapped=False)
        stale = past_valid_prefix(seen["restores"], eng.config.block_size)
        if stale:
            raise AssertionError(f"reuse at {n_cpu} CPU blocks: restores "
                                 f"past the valid prefix (request, first, "
                                 f"end, valid, KV positions): {stale}")
        st = eng.reuse.stats()
        if st["short_copy_resumes"] < 1:
            raise AssertionError(f"reuse at {n_cpu} CPU blocks: no short "
                                 f"copy resumed: {st}")
        tokens = [check_tokens(eng, bundle, c) for c in convs]
        if bundle["params"]["embed"]["table"].is_cuda and \
                min(launched.values()) <= 0:
            raise AssertionError(f"reuse at {n_cpu} CPU blocks: a kernel "
                                 f"never launched: {launched}")
        out[str(n_cpu)] = {
            "host_pool_mb": n_cpu * eng.block_bytes / 1e6,
            "contaminations": st["contaminations"],
            "swap_ins": len(seen["swap_ins"]),
            "short_copy_swap_ins": len(
                short_swap_ins(seen["swap_ins"])),
            "restores_past_valid_prefix": len(stale),
            "short_copy_resumes": st["short_copy_resumes"],
            "short_copy_restored_tokens": st["short_copy_restored_tokens"],
            "short_copy_recomputed_tokens":
                st["short_copy_recomputed_tokens"],
            "wall_s": wall, "launches": launched,
            "preemptions": checked["preemptions"],
            "prefill_chunks": checked["prefill_chunks"],
            "greedy_equal": sum(r["equal"] for r in tokens),
            "greedy_near_ties": sum(r["near_ties"] for r in tokens),
            "greedy_max_gap": max(r["max_gap"] for r in tokens),
            "tolerance": NEAR_TIE}
        eng.shutdown()
    return out


# ---------------------------------------------------------------------------
# phase 5p: the paper's four-policy ladder (mistral-nemo-12b)
# ---------------------------------------------------------------------------

LADDER_ARCH = "mistral-nemo-12b"
# host seconds by method reported per policy (``run_engine``'s timers)
LADDER_METHODS = ("prefill_chunk_compute", "decode", "flush",
                  "copy_out_staged", "copy_in_staged")


def watch_moved_kv(pools) -> dict:
    """Hold every staged swap of ``pools`` byte for byte: once a
    ``copy_out_staged`` returns, the host blocks it wrote equal the device
    blocks it read; once a ``copy_in_staged`` returns, the device blocks
    it wrote equal the host blocks it read.  (A swap-out's source blocks
    stay unwritten until its task completes: an allocation that takes
    one first waits for the task, ``resolve_conflicts``.)  Each check
    reads the device blocks back, so a run watched so is not timed.
    Returns the blocks checked each way, filled as the engine runs;
    raises ``AssertionError`` at a difference."""
    import torch
    from repro_torch.kernels.block_copy import runs_to_indices
    seen = {"out_blocks": 0, "in_blocks": 0}
    real_out, real_in = pools.copy_out_staged, pools.copy_in_staged
    s = pools.spec
    planes = s.n_layers * 2
    host = torch.from_numpy(pools.cpu.view("int16")).view(
        planes, s.num_cpu_blocks, -1)

    def held(direction, runs, cpu_ids):
        idx = runs_to_indices(runs)
        gpu = pools.gpu_full()
        dev = gpu.view(torch.int16).view(planes, gpu.shape[2], -1)
        dev = dev.index_select(1, torch.as_tensor(idx, device=gpu.device))
        back = torch.empty(dev.shape, dtype=dev.dtype,
                           pin_memory=dev.is_cuda)
        back.copy_(dev)
        want = host.index_select(1, torch.as_tensor(list(cpu_ids)))
        if not torch.equal(back, want):
            raise AssertionError(f"swap-{direction} of device blocks {idx} "
                                 f"and host blocks {list(cpu_ids)}: the "
                                 "bytes differ")
        seen[f"{direction}_blocks"] += len(idx)

    def copy_out(runs, cpu_ids, **k):
        real_out(runs, cpu_ids, **k)
        held("out", runs, cpu_ids)

    def copy_in(cpu_ids, runs, *a, **k):
        real_in(cpu_ids, runs, *a, **k)
        held("in", runs, cpu_ids)
    pools.copy_out_staged, pools.copy_in_staged = copy_out, copy_in
    return seen


@contextlib.contextmanager
def full_precision():
    """Within the block the model computes in fp32 (``layers.
    COMPUTE_DTYPE``): the activations are fp32 and each bf16 weight is
    upcast, exactly, where a layer casts it at use, so a dense forward
    gives the model's function of its bf16 weights with no bf16 rounding
    of its own (with TF32 off)."""
    import torch
    from repro_torch.models import layers as L
    real = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        L.COMPUTE_DTYPE = real


def ladder_run(bundle, convs, sizes: dict, policy: str,
               watch: bool = False, on_engine=None) -> tuple:
    """One engine run of ``policy`` on ``bundle`` with swap tasks held to
    the simulated clock (so a policy's runs repeat), the serving kernels'
    launch counts set to 0 just before; with ``watch``, every swap held
    byte for byte (``watch_moved_kv``); ``on_engine`` is called with the
    engine before it runs.  The run must finish every turn, swap both
    ways, retry and fail no copy, leak nothing and, on CUDA, launch every
    serving kernel.  Returns (engine, its record)."""
    from repro_torch.kernels import block_copy as bc
    from repro_torch.kernels import launches
    from repro_torch.kernels import paged_attention as pa
    kernels = {"paged_attention": pa.paged_attention,
               "block_gather_runs": bc.block_gather_runs,
               "block_scatter_runs": bc.block_scatter_runs}
    moved = {}

    def prepare(e):
        if watch:
            moved.update(blocks=watch_moved_kv(e.pools))
        if on_engine is not None:
            on_engine(e)
    launches.reset(*kernels.values())
    t0 = time.perf_counter()
    with swaps_follow_the_clock() as hold:
        eng, wall, host, swaps = run_engine(
            bundle, convs, policy=policy, **sizes, on_engine=prepare)
    setup_s = time.perf_counter() - t0 - wall
    launched = {k: w.launches for k, w in kernels.items()}
    checked = check_engine(eng, convs, swaps, every_conv_swapped=False)
    moved = moved.get("blocks")
    if watch and not (moved["out_blocks"] and moved["in_blocks"]):
        raise AssertionError(f"{policy}: no block checked one way: {moved}")
    check_reclaimed(eng)
    if bundle["params"]["embed"]["table"].is_cuda and \
            min(launched.values()) <= 0:
        raise AssertionError(f"{policy}: a serving kernel never launched: "
                             f"{launched}")
    sw = eng.swap.stats()
    return eng, {
        "wall_s": wall, "setup_s": setup_s,
        "tokens_per_s": checked["tokens"] / wall,
        "host_s_by_method": {k: host.get(k, 0.0) for k in LADDER_METHODS},
        "clock_hold_wait_s": hold["wait_s"],
        "swap_ops": {"out": sw["ops_out"], "in": sw["ops_in"]},
        "blocks_moved": {"out": sw["blocks_out"], "in": sw["blocks_in"]},
        "swap_gb": {"out": sw["blocks_out"] * eng.block_bytes / 1e9,
                    "in": sw["blocks_in"] * eng.block_bytes / 1e9},
        "launches": launched, "moved_kv_blocks_checked": moved,
        **{k: checked[k] for k in (
            "preemptions", "swap_out_calls", "swap_in_calls",
            "fenced_swap_ins", "d2h_transfers", "h2d_transfers",
            "decode_steps", "prefill_chunks", "graphs_captured",
            "copy_retries", "copy_failures")},
        "a10_modelled_p99_ttft_ms": eng.metrics.summary()["p99_ttft_ms"]}


# mistral-nemo-12b at random bf16 weights: its bf16 rounding moves a
# logit by more than NEAR_TIE, so a few greedy tokens part from the dense
# argmax by more than NEAR_TIE.  The reference is the dense forward in
# fp32 of the same bf16 weights (``full_precision``).  A token is accepted
# within the spread, the largest distance of the bf16 and fp32 dense
# forwards' logits at the generated positions measured in the same run
# (how far a plain bf16 forward of this model moves a logit), and never
# less than NEAR_TIE; and at least LADDER_NEAR_TIE_SHARE of each policy's
# tokens must lie within NEAR_TIE, so that a fault moving many tokens a
# little fails too.  (Two plain forwards differing only in the attention
# route, gemma3's spread, agree exactly at this model's lengths.)
LADDER_NEAR_TIE_SHARE = 0.975


def ladder_tokens(bundle, convs, hists: dict) -> dict:
    """Every policy's greedy tokens (``hists``: {policy: {conv: history}})
    against the dense forward in fp32 of the bf16 weights and, beside it,
    the bf16 one (``token_gaps``; one pair of forwards per distinct
    history), and every two policies' first parting by the fp32 forward.
    Returns per policy the tokens equal to the fp32 argmax, within
    NEAR_TIE, the largest gap, and the bf16 forward's equal tokens and
    largest gap; the partings per pair, as (position, |gap| of the two
    tokens); the spread (the largest |fp32 - bf16| logit distance over
    every history) and the tolerance, max(NEAR_TIE, spread).  Gates
    nothing."""
    rows, spread = {}, 0.0
    for hist in hists.values():
        for c in convs:
            h = tuple(hist[c.conv_id])
            if h in rows:
                continue
            pos = generated_positions(c)
            if len(h) != pos[-1] + 1:
                raise AssertionError(f"conv {c.conv_id}: history of "
                                     f"{len(h)} tokens")
            bf16 = dense_logits(bundle, h, pos)
            with full_precision():
                fp32 = dense_logits(bundle, h, pos)
            spread = max(spread, float((fp32 - bf16).abs().max()))
            rows[h] = (pos, fp32, bf16)
    per = {}
    for pol, hist in hists.items():
        f, b = [], []
        for c in convs:
            h = hist[c.conv_id]
            pos, fp32, bf16 = rows[tuple(h)]
            f.append(token_gaps(fp32, h, pos, math.inf))
            b.append(token_gaps(bf16, h, pos, math.inf))
        per[pol] = {"greedy_generated": sum(r["generated"] for r in f),
                    "greedy_equal": sum(r["equal"] for r in f),
                    "greedy_within_near_tie": sum(r["within_near_tie"]
                                                  for r in f),
                    "greedy_max_gap": max(r["max_gap"] for r in f),
                    "bf16_dense_equal": sum(r["equal"] for r in b),
                    "bf16_dense_max_gap": max(r["max_gap"] for r in b)}
    pairs, names = {}, list(hists)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            parts = []
            for c in convs:
                ha, hb = hists[a][c.conv_id], hists[b][c.conv_id]
                at = next((j for j, (x, y) in enumerate(zip(ha, hb))
                           if x != y), None)
                if at is None:
                    continue
                pos, fp32, _ = rows[tuple(ha)]
                row = fp32[pos.index(at)]
                parts.append((at, float((row[ha[at]] - row[hb[at]]).abs())))
            pairs[f"{a} / {b}"] = {"equal": len(convs) - len(parts),
                                   "parting_at": parts}
    return {"policies": per, "streams": pairs, "spread": spread,
            "tolerance": max(NEAR_TIE, spread)}


# the profiled fastswitch run's window, engine iterations [first, last)
# of its ~115: stopping a profile of the whole run (~309,000 device
# events) took most of 21-35 s, and of iterations 30-69 (118,047 events)
# ~13 s, on an H100; this window, mid-run, holds decode steps of both
# turns, prefill chunks and swaps
PROFILE_WINDOW = (40, 55)


def profile_window(eng, prof, window, sync) -> dict:
    """Wrap ``eng.step`` so that ``prof`` (``start`` / ``stop``) records
    the engine iterations [first, last) of ``window``: started just
    before iteration first, stopped just after iteration last - 1, each
    behind ``sync()``.  Returns a dict filled as the engine runs: the
    window's host seconds (``wall_s``) and iterations recorded, and
    ``close``, which stops a window the run ended inside (a no-op
    otherwise)."""
    first, last = window
    real = eng.step
    win = {"wall_s": None, "iterations": 0, "n": 0, "t0": None}

    def close():
        if win["t0"] is None or win["wall_s"] is not None:
            return
        sync()
        win["wall_s"] = time.perf_counter() - win["t0"]
        win["iterations"] = win["n"] - first
        prof.stop()

    def step():
        if win["n"] == first:
            sync()
            prof.start()
            win["t0"] = time.perf_counter()
        real()
        win["n"] += 1
        if win["n"] == last:
            close()
    eng.step = step
    win["close"] = close
    return win


def profile_idle(bundle, convs, sizes: dict) -> dict:
    """One more run of fastswitch (``ladder_run``) with the device's
    activity in iterations ``PROFILE_WINDOW`` recorded by
    ``torch.profiler`` (``profile_window``): the share of the window's
    wall time in which
    the device ran nothing (its kernels and copies merged into busy
    intervals; the profiler slows the host, so an upper bound).  Read
    from the profiler's raw events: building ``prof.events()`` for a
    run's ~300,000 device operations takes tens of seconds.  Where the
    profiler gives no device event, the share is None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    prof = profile(activities=[ProfilerActivity.CUDA])
    held = {}

    def on_engine(e):
        held["win"] = profile_window(e, prof, PROFILE_WINDOW,
                                     torch.cuda.synchronize)
    eng, rec = ladder_run(bundle, convs, sizes, "fastswitch",
                          on_engine=on_engine)
    win = held["win"]
    win["close"]()
    eng.shutdown()
    spans = [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    busy = busy_seconds(spans) if spans else None
    return {"policy": "fastswitch", "wall_s": rec["wall_s"],
            "window": list(PROFILE_WINDOW),
            "window_iterations": win["iterations"],
            "window_wall_s": win["wall_s"], "device_busy_s": busy,
            "device_idle_share": (1.0 - busy / win["wall_s"]
                                  if spans else None),
            "device_ops": len(spans),
            "seconds": time.perf_counter() - t0}


def ladder_phase(bundle, convs, sizes: dict) -> dict:
    """The paper's ladder (``POLICY_ORDER``: vllm, +dbg, +dbg+reuse,
    fastswitch) through the engine in real mode on ``bundle``, each a
    fresh engine over the same workload and pool.  Per policy a watched
    run (every swap byte-equal, ``watch_moved_kv``; the first pays the
    process's one-time costs), then the timed run, whose tokens must
    equal the watched run's; both finish every turn, swap both ways,
    retry and fail no copy, leak nothing and launch every serving
    kernel.  On CUDA, one more fastswitch run, iterations
    ``PROFILE_WINDOW`` of it under ``torch.profiler``, gives the device's
    idle share.  Then (``ladder_tokens``) every
    greedy token is the fp32 dense argmax or within max(NEAR_TIE, the
    spread of the bf16 and fp32 dense forwards), at least
    ``LADDER_NEAR_TIE_SHARE`` of each policy's tokens within NEAR_TIE,
    and every two policies' streams are equal or first part within the
    tolerance.  Each run's seconds and the token record go to standard
    error as they come."""
    import torch
    from repro_torch.launch.scenarios import POLICY_ORDER
    out, hists = {}, {}
    for pol in POLICY_ORDER:
        t0 = time.perf_counter()
        eng, seen = ladder_run(bundle, convs, sizes, pol, watch=True)
        watched = dict(eng._token_hist_by_conv)
        eng.shutdown()
        del eng
        gc.collect()
        watched_s = time.perf_counter() - t0
        eng, rec = ladder_run(bundle, convs, sizes, pol)
        if eng._token_hist_by_conv != watched:
            raise AssertionError(f"{pol}: the timed run's tokens differ "
                                 "from the watched run's")
        rec.update(moved_kv_blocks_checked=seen["moved_kv_blocks_checked"],
                   watched_run_s=watched_s)
        hists[pol] = dict(eng._token_hist_by_conv)
        out[pol] = rec
        eng.shutdown()
        del eng
        gc.collect()
        print(json.dumps({"ladder_policy": pol, **rec}), file=sys.stderr,
              flush=True)
    profiled = None
    if torch.cuda.is_available() and \
            bundle["params"]["embed"]["table"].is_cuda:
        profiled = profile_idle(bundle, convs, sizes)
    t0 = time.perf_counter()
    toks = ladder_tokens(bundle, convs, hists)
    toks["dense_check_s"] = time.perf_counter() - t0
    print(json.dumps({"ladder_tokens": toks}), file=sys.stderr, flush=True)
    tol = toks["tolerance"]
    worst = {p: r["greedy_max_gap"] for p, r in toks["policies"].items()
             if r["greedy_max_gap"] >= tol}
    if worst:
        raise AssertionError(f"greedy tokens below the fp32 dense maximum by "
                             f"{tol} or more: {worst}")
    few = {p: f"{r['greedy_within_near_tie']} of {r['greedy_generated']}"
           for p, r in toks["policies"].items()
           if r["greedy_within_near_tie"]
           < LADDER_NEAR_TIE_SHARE * r["greedy_generated"]}
    if few:
        raise AssertionError(f"fewer than {LADDER_NEAR_TIE_SHARE} of the "
                             f"greedy tokens within {NEAR_TIE} of the fp32 "
                             f"dense maximum: {few}")
    apart = {k: [d for d in v["parting_at"] if d[1] >= tol]
             for k, v in toks["streams"].items()}
    apart = {k: v for k, v in apart.items() if v}
    if apart:
        raise AssertionError(f"policies part at (position, gap) past "
                             f"{tol}: {apart}")
    for pol, r in toks["policies"].items():
        out[pol].update(r)
    cfg = bundle["cfg"]
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "policies": out,
            "streams": toks["streams"], "near_tie": NEAR_TIE,
            "near_tie_share": LADDER_NEAR_TIE_SHARE,
            "dense_spread": toks["spread"], "tolerance": tol,
            "dense_reference": "fp32 forward of the bf16 weights",
            "dense_check_s": toks["dense_check_s"], "profiled": profiled}


# ---------------------------------------------------------------------------
# phase 5r: the reference's real-mode configs on the card
# ---------------------------------------------------------------------------

# the archs the paged path serves (``supports_paged``) at their reduced
# configs, the models the reference's real mode serves: d_model 256, 2
# layers, 4 query heads of 64 over 2 KV heads (olmoe's 4 / 4, 4 experts)
REDUCED_ARCHS = ("qwen2-1.5b", "olmoe-1b-7b", "llama3.2-3b",
                 "mistral-nemo-12b", "llava-next-mistral-7b")
REDUCED_POLICIES = ("vllm", "fastswitch")
REDUCED_SMOKE_ARCH = "qwen2-1.5b"


def reduced_bundles(arch: str, device) -> tuple:
    """(card bundle, CPU bundle) of ``arch``'s reduced config: bf16
    serving weights drawn once from SEED on the CPU, then copied to
    ``device``, so both runs hold the same bits."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import tree_map
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, seed=SEED, device="cpu", serving=True)
    return ({"cfg": cfg, "params": tree_map(lambda t: t.to(device), params)},
            {"cfg": cfg, "params": params})


@contextlib.contextmanager
def engine_gaps():
    """Within the block, every engine call that produces a token records
    its gaps as the engine computed them (eager calls: a CPU run): a
    decode step's row its top-2 logit gap and its least routing gap (the
    K-th to (K+1)-th router probability over the layers; inf without a
    MoE), a prefill chunk its last logits' top-2 gap and the least
    routing gap over the chunk's positions.  Yields {the tokens before
    the produced token: (logit gap, routing gap)}, the least over the
    calls that produced it."""
    import torch
    from repro_torch.core import decode_runner as dr
    from repro_torch.models import moe, paged
    calls, seen = {}, {"gaps": [], "logits": None}
    real_route, real_sample = moe.route, paged.sample_tokens
    real_stage = dr.DecodeRunner._stage_tokens
    real_compute = dr.DecodeRunner.prefill_chunk_compute

    def top2(logits) -> float:
        top = torch.topk(logits.float(), 2).values
        return float(top[0] - top[1])

    def routing(n: int):
        gaps = seen["gaps"]
        seen["gaps"] = []
        if not gaps:
            return torch.full((n,), math.inf)
        return torch.stack(gaps).min(dim=0).values

    def note(key, logit_gap: float, route_gap: float) -> None:
        old = calls.get(key, (math.inf, math.inf))
        calls[key] = (min(old[0], logit_gap), min(old[1], route_gap))

    def route(router, xf, m):
        plan = real_route(router, xf, m)
        top = torch.sort(plan.probs, dim=-1, descending=True).values
        seen["gaps"].append((top[:, m.top_k - 1] - top[:, m.top_k]).cpu())
        return plan

    def sample_tokens(logits, *a, **k):
        seen["logits"] = logits
        return real_sample(logits, *a, **k)

    def stage(runner, nxt, rows_hist):
        gaps = routing(seen["logits"].shape[0])
        for row, hist in rows_hist:
            note(tuple(hist), top2(seen["logits"][row]), float(gaps[row]))
        return real_stage(runner, nxt, rows_hist)

    def compute(runner, rid, n_tokens):
        st = runner._prefills[rid]
        pos, toks = st.pos, list(st.toks)
        seen["gaps"] = []
        out = real_compute(runner, rid, n_tokens)
        if n_tokens > 0:
            gaps = routing(n_tokens)
            note(tuple(toks[:pos + n_tokens]), top2(st.last_logits),
                 float(gaps[:n_tokens].min()))
        return out
    moe.route, paged.sample_tokens = route, sample_tokens
    dr.DecodeRunner._stage_tokens = stage
    dr.DecodeRunner.prefill_chunk_compute = compute
    try:
        yield calls
    finally:
        moe.route, paged.sample_tokens = real_route, real_sample
        dr.DecodeRunner._stage_tokens = real_stage
        dr.DecodeRunner.prefill_chunk_compute = real_compute


def reduced_gate(card: dict, cpu: dict) -> dict:
    """One policy's card run against its CPU run (``card`` / ``cpu``:
    {"hists": {conv: history}, "rec": ``ladder_run``'s record, "on_card":
    bool}, the CPU's also "gaps", its ``engine_gaps``): swap ops and
    blocks each way equal (both runs held to the simulated clock); every
    stream equal, or first parting at a token whose CPU engine call had a
    top-2 logit gap under NEAR_TIE or, in a MoE, a routing gap under
    ROUTE_TIE (an expert flipped there moves the hidden state by a whole
    expert's output, which no logit bound covers); on the card, paged
    attention launched.  Returns the record, the partings as (conv,
    position, logit gap, routing gap or None without a MoE); raises
    ``AssertionError`` at the first miss."""
    for key in ("swap_ops", "blocks_moved"):
        if card["rec"][key] != cpu["rec"][key]:
            raise AssertionError(f"{key}: card {card['rec'][key]}, CPU "
                                 f"{cpu['rec'][key]}")
    if set(card["hists"]) != set(cpu["hists"]):
        raise AssertionError("the runs served other conversations")
    parts = []
    for cid, want in sorted(cpu["hists"].items()):
        got = card["hists"][cid]
        at = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                  None)
        if at is None:
            if len(got) != len(want):
                raise AssertionError(f"conv {cid}: {len(got)} tokens on the "
                                     f"card, {len(want)} on the CPU")
            continue
        gaps = cpu["gaps"].get(tuple(want[:at]))
        if gaps is None:
            raise AssertionError(f"conv {cid}: no CPU engine call produced "
                                 f"position {at}")
        if not (gaps[0] < NEAR_TIE or gaps[1] < ROUTE_TIE):
            raise AssertionError(f"conv {cid}: the card's stream parts from "
                                 f"the CPU's at {at}, where the CPU's "
                                 f"logit gap is {gaps[0]} (>= {NEAR_TIE}) "
                                 f"and its routing gap {gaps[1]} (>= "
                                 f"{ROUTE_TIE})")
        parts.append([cid, at, gaps[0],
                      gaps[1] if math.isfinite(gaps[1]) else None])
    launched = card["rec"]["launches"]
    if card["on_card"] and launched["paged_attention"] <= 0:
        raise AssertionError(f"paged attention never launched: {launched}")
    return {"swap_ops": card["rec"]["swap_ops"],
            "blocks_moved": card["rec"]["blocks_moved"],
            "streams_equal": len(cpu["hists"]) - len(parts),
            "parting_at": parts, "launches": launched,
            "moved_kv_blocks_checked": {
                "card": card["rec"]["moved_kv_blocks_checked"],
                "cpu": cpu["rec"]["moved_kv_blocks_checked"]},
            "wall_s": {"card": card["rec"]["wall_s"],
                       "cpu": cpu["rec"]["wall_s"]}}


def reduced_cpu_run(arch: str, policy: str, convs, sizes: dict) -> dict:
    """``arch``'s reduced config under ``policy`` on the CPU
    (``reduced_bundles``' CPU bundle; ``ladder_run`` with every staged
    swap held byte for byte), its engine gaps recorded (``engine_gaps``),
    at one PyTorch thread (a worker process beside others): the run as
    ``reduced_gate`` takes it."""
    import torch
    torch.set_num_threads(1)
    _, cpu_b = reduced_bundles(arch, "cpu")
    with engine_gaps() as gaps:
        eng, rec = ladder_run(cpu_b, convs, sizes, policy, watch=True)
    eng.shutdown()
    return {"hists": dict(eng._token_hist_by_conv), "rec": rec,
            "gaps": dict(gaps), "on_card": False}


def reduced_phase(device, out_dir: Path, archs=REDUCED_ARCHS) -> dict:
    """The reference's real-mode models on ``device``: each arch of
    ``archs`` at its reduced config (head_dim 64) through the engine
    phase's workload and pool under REDUCED_POLICIES, each run held by
    ``reduced_gate`` to the same run on the CPU with the same weights
    (``reduced_bundles``); the CPU runs go in worker processes
    (``reduced_cpu_run``, one PyTorch thread each) while this process
    makes the device's runs, each a fresh engine, every staged swap held
    byte for byte.  Beside them, the reference's tier-1 real smoke
    through the launcher, ``--online --smoke --real --device cuda
    --reduced`` (exit 0 with its drain and token assertions, paged
    attention launched); on the CPU the smoke is ``--device cpu``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
    convs = conversations(8, (256, 288, 320, 352), (96, 128, 160),
                          max_tokens=32)
    sizes = dict(gpu_blocks=160, cpu_blocks=1024, max_running=8)
    on_card = str(device).startswith("cuda")
    argv = ["--online", "--smoke", "--real", "--arch", REDUCED_SMOKE_ARCH]
    argv += ["--device", "cuda", "--reduced"] if on_card else \
        ["--device", "cpu"]
    t0 = time.perf_counter()
    archs_out = {}
    # the launcher's smoke (a subprocess, mostly its start-up) and the
    # CPU runs (a worker process a run, each ~6-13 s at one thread on the
    # chip's host) run beside the card's runs
    with ThreadPoolExecutor(1) as waiter, ProcessPoolExecutor(
            len(archs) * len(REDUCED_POLICIES),
            multiprocessing.get_context("spawn")) as pool:
        smoke_run = waiter.submit(run_launcher, argv, out_dir)
        cpu_runs = {(arch, pol): pool.submit(reduced_cpu_run, arch, pol,
                                             convs, sizes)
                    for arch in archs for pol in REDUCED_POLICIES}
        for arch in archs:
            t1 = time.perf_counter()
            card_b, cpu_b = reduced_bundles(arch, device)
            cfg = cpu_b["cfg"]
            out = {"head_dim": cfg.head_dim, "n_heads": cfg.n_heads,
                   "n_kv_heads": cfg.n_kv_heads, "d_model": cfg.d_model,
                   "n_layers": cfg.n_layers}
            card = {}
            for pol in REDUCED_POLICIES:
                eng, rec = ladder_run(card_b, convs, sizes, pol, watch=True)
                card[pol] = {"hists": dict(eng._token_hist_by_conv),
                             "rec": rec, "on_card":
                                 card_b["params"]["embed"]["table"].is_cuda}
                eng.shutdown()
                del eng
                gc.collect()
            card_s = time.perf_counter() - t1
            for pol in REDUCED_POLICIES:
                out[pol] = reduced_gate(card[pol],
                                        cpu_runs[arch, pol].result())
            out.update(card_seconds=card_s,
                       seconds=time.perf_counter() - t1)
            archs_out[arch] = out
            print(json.dumps({"reduced_arch": arch, **out}),
                  file=sys.stderr, flush=True)
        smoke = smoke_run.result()
    launched = smoke["results"]["kernel_launches"]
    if on_card and launched["paged_attention"] <= 0:
        raise AssertionError(f"the launcher's reduced smoke never launched "
                             f"paged attention: {launched}")
    return {"archs": archs_out, "policies": list(REDUCED_POLICIES),
            "near_tie": NEAR_TIE, "route_tie": ROUTE_TIE,
            "launcher_smoke": {"argv": argv, "wall_s": smoke["wall_s"],
                               "total_tokens":
                                   smoke["results"]["total_tokens"],
                               "kernel_launches": launched,
                               "stdout": smoke["stdout"][-3:]},
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 5g: MoE serving (olmoe-1b-7b)
# ---------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"
# the moe phase's oracle step: the CUDA paged attention against its plain
# version on the same state, the plain step's tokens sent to the experts
# the kernel step chose.  Both attentions round once to bf16 (one ulp
# apart at most, ATTN_RTOL), and 16 layers of bf16 activations carry that
# to the fp32 logits (spread ~0.9 at random weights): a tiny difference
# moves an element of the residual stream by a whole bf16 ulp.  A router
# that chose freely could also flip a token's expert at a near-tie, which
# moves its hidden state by a whole expert's output, and that no logit
# bound covers; the free step's flips are counted beside the check.
# Held per logit to MOE_LOGIT_ATOL (twice the near-tie rule); the argmax
# equal, or a near-tie (NEAR_TIE) of the plain step.
MOE_LOGIT_ATOL = 0.1


@contextlib.contextmanager
def swaps_follow_the_clock(*modules):
    """Within the block, a swap task whose modelled end the simulated
    clock has passed waits for its copy before it reports complete
    (``SwapTask.is_completed`` of each swap-manager module given, by
    default the port's), where it would otherwise stay in flight for
    another poll while a worker thread still copies.  Which requests
    decode together then follows the simulated clock alone, not the
    threads' speed: a MoE row's tokens depend on its bucket's other rows
    through capacity, so only then do two identical runs give equal
    tokens.  Yields {"wait_s": seconds spent waiting for copies}."""
    import concurrent.futures
    if not modules:
        from repro_torch.core import swap_manager
        modules = (swap_manager,)
    held = {"wait_s": 0.0}
    reals = [m.SwapTask.is_completed for m in modules]

    def holding(real):
        def is_completed(task, now_us):
            if task.future is not None and now_us >= task.done_at \
                    and not task.future.done():
                t0 = time.perf_counter()
                concurrent.futures.wait([task.future])
                held["wait_s"] += time.perf_counter() - t0
            return real(task, now_us)
        return is_completed
    for m, real in zip(modules, reals):
        m.SwapTask.is_completed = holding(real)
    try:
        yield held
    finally:
        for m, real in zip(modules, reals):
            m.SwapTask.is_completed = real


@contextlib.contextmanager
def fullest_replays():
    """Within the block, keeps per (batch, pages) bucket the step tensors
    of the first replay with the most active rows: {bucket: {"active": n,
    "clones": clones of the tensors before the replay}}.  Reads each
    replay's active count on the host (a synchronise)."""
    from repro_torch.core import decode_runner as dr
    real = dr._StepGraph.replay
    snaps = {}

    def replay(graph, tensors):
        bucket = tuple(tensors[dr.STEP_TENSORS.index("block_tables")].shape)
        n = int(tensors[dr.STEP_TENSORS.index("active")].sum())
        if n > snaps.get(bucket, {"active": 0})["active"]:
            snaps[bucket] = {"active": n,
                             "clones": [_clone(t) for t in tensors]}
        return real(graph, tensors)
    dr._StepGraph.replay = replay
    try:
        yield snaps
    finally:
        dr._StepGraph.replay = real


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def moe_step_bytes(params, cfg, ctx, experts=None) -> float:
    """Bytes one decode step must move: every parameter it reads once
    (the embedding's rows only), each row's walked K/V (ctx + 1 tokens)
    and its new K/V row written.  Of the experts' weights, given
    ``experts`` (per layer, how many distinct experts the step's rows
    reach), only those experts'; else all of them, as the port's dense
    dispatch multiplies every expert's buffer."""
    ffn = params["layers"]["ffn"]
    nbytes = sum(t.numel() * t.element_size()
                 for name, sub in params.items() if name != "embed"
                 for t in _leaves(sub))
    if experts is not None:
        per_expert = sum(ffn[k].numel() * ffn[k].element_size()
                         for k in EXPERT_LEAVES) / (
            cfg.n_layers * cfg.moe.n_experts)
        nbytes -= per_expert * (cfg.n_layers * cfg.moe.n_experts
                                - sum(experts))
    B = ctx.numel()
    tok_kv = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    nbytes += B * cfg.d_model * 4                     # the embedded rows
    nbytes += int((ctx.long() + 1).sum()) * tok_kv + B * tok_kv
    return float(nbytes)


def replay_ops(replay, iters: int = 5, top: int = 8) -> dict:
    """Device time of ``iters`` calls of ``replay`` (a captured graph's
    replay) under ``torch.profiler``: per call, the device ms of all its
    kernels and of the ``top`` operations by time, with their counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            replay()
        torch.cuda.synchronize()
    events = _device_events(prof)
    if not events:
        raise AssertionError("the profiler recorded no kernel of the replay")
    by_name = {}
    for e in events:
        n_us = by_name.setdefault(e.name[:60], [0, 0.0])
        n_us[0] += 1
        n_us[1] += e.time_range.end - e.time_range.start
    ops_ = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_ms": sum(us for _, us in by_name.values()) / 1e3 / iters,
            "kernels": len(events) / iters,
            "top": [{"name": n, "count": c / iters, "ms": us / 1e3 / iters}
                    for n, (c, us) in ops_]}


def moe_oracle(eng, snap, tol: float = NEAR_TIE) -> dict:
    """One decode step at the engine's bucket from the snapshot's state,
    with the CUDA paged attention and with ``paged_attention_plain`` on
    the same tensors (each on its own copy of the pool), the plain step's
    tokens sent to the experts the kernel step chose: per active row, the
    logits within MOE_LOGIT_ATOL and the argmax equal, or a near-tie of
    the plain step's logits.  A third, free plain step counts the rows
    whose experts differ from the kernel step's somewhere (``flip``: the
    first such layer and its K-th to (K+1)-th probability gap).  Raises
    with every row's record where a row fails."""
    import torch
    from repro_torch.core import decode_runner as dr
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models import paged
    cfg = eng.runner.mb["cfg"]
    params = eng.runner._params
    t = dict(zip(dr.STEP_TENSORS, snap["clones"]))
    real_route, real_attention = moe.route, ops.paged_attention

    def plain_attention(*a, **k):
        return pa.paged_attention_plain(*a, **k)

    active = t["active"].cpu()

    def step(attention, pinned=None):
        """(logits, per layer (experts as sets, K/K+1 gaps, experts, how
        many distinct experts the active rows' kept pairs reach))."""
        plans = []

        def route(router, xf, m):
            plan = real_route(router, xf, m)
            if pinned is not None:
                plan = moe.plan_for(plan.probs, pinned[len(plans)][2], m)
            top = torch.sort(plan.probs, dim=-1, descending=True).values
            eids, slot = plan.eids.cpu(), plan.slot.cpu()
            kept = eids[active][slot[active] < plan.capacity]
            plans.append((eids.sort(dim=-1).values,
                          (top[:, m.top_k - 1] - top[:, m.top_k]).cpu(),
                          plan.eids, int(torch.unique(kept).numel())))
            return plan
        moe.route, ops.paged_attention = route, attention
        try:
            with torch.no_grad():
                x, _ = paged._decode_hidden(
                    params, t["pool"].clone(), t["block_tables"],
                    t["context_lens"].clone(), t["tokens"], cfg)
                head = (params["embed"] if cfg.tie_embeddings
                        else params["lm_head"])
                return L.unembed(head, x).cpu(), plans
        finally:
            moe.route, ops.paged_attention = real_route, real_attention

    lk, pk = step(real_attention)
    lp, _ = step(plain_attention, pinned=pk)
    _, pf = step(plain_attention)
    records, faults = [], []
    for r in torch.nonzero(active)[:, 0].tolist():
        a, b = int(lk[r].argmax()), int(lp[r].argmax())
        rec = {"row": r, "ctx": int(t["context_lens"][r]),
               "logit_err": float((lk[r] - lp[r]).abs().max()),
               "argmax_gap": float(lp[r, b] - lp[r, a])}
        differ = [i for i, (k, f) in enumerate(zip(pk, pf))
                  if not torch.equal(k[0][r], f[0][r])]
        if differ:
            rec["flip"] = {"layer": differ[0],
                           "gap": float(pf[differ[0]][1][r])}
        if not rec["logit_err"] <= MOE_LOGIT_ATOL:
            faults.append(f"row {r}: logits {rec['logit_err']} from the "
                          f"plain step's (> {MOE_LOGIT_ATOL})")
        if a != b and rec["argmax_gap"] >= tol:
            faults.append(f"row {r}: the kernel step's argmax {a} is "
                          f"{rec['argmax_gap']} below the plain step's")
        records.append(rec)
    if faults:
        raise AssertionError(f"{faults}; rows: {json.dumps(records)}")
    return {"rows": records,
            "routed_experts_per_layer": [p[3] for p in pk],
            "max_abs_logit_err": max(r["logit_err"] for r in records),
            "argmax_near_ties": sum(r["argmax_gap"] > 0 for r in records),
            "free_routing_flips": sum("flip" in r for r in records),
            "tolerance": {"logit_atol": MOE_LOGIT_ATOL, "near_tie": tol}}


def moe_phase(device, out_dir: Path, cfg=None,
              profile: bool = False) -> dict:
    """olmoe-1b-7b at full width (``cfg``: another config, for a rehearsal
    on the CPU) served by ``ServingEngine`` in real mode with the engine
    phase's workload: 8 two-turn conversations, 160 GPU and 1024 CPU
    blocks, fastswitch, the storm of seed 13; a warm-up run (each bucket's
    first replay held against its eager step, and the fullest replay of
    each bucket kept), then the timed run with the serving kernels' counts
    set to 0 just before, both with swap tasks held to the simulated
    clock (``swaps_follow_the_clock``; the timed run's waits for copies
    are reported), then the same workload unheld, as ``launch.serve``
    runs it (its wall).  Checks: every turn finished, no copy retried or
    failed, every conversation swapped out and back in (``check_engine``,
    all three runs); the two held runs' token histories identical; paged
    attention once per layer per step and both run copies launched; the
    oracle step (``moe_oracle``).  Times one replay of the last bucket's
    graph over its fullest state beside the step's bound (the weights of
    the experts the active rows' kept pairs reach, per layer) and its
    dense-dispatch bound (all experts' weights), and with ``profile`` its
    kernels by operation (``replay_ops``).  Then the launcher, ``--real
    --arch olmoe-1b-7b --conversations 2 --policy fastswitch``, as a
    subprocess once the phase's tensors are freed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import decode_runner as dr
    from repro_torch.kernels import launches as kl
    from repro_torch.launch.serve import _serving_kernels
    from repro_torch.models import transformer as T
    kind = torch.device(device).type
    cuda = kind == "cuda"
    cfg = cfg or get_config(MOE_ARCH)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = {"cfg": cfg, "params": T.init_params(
        cfg, seed=SEED, device=device, serving=True)}
    init_s = time.perf_counter() - t0
    mem = ({"after_init_gb": torch.cuda.memory_allocated() / 1e9,
            "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
           if cuda else {})
    convs = conversations(8, (256, 288, 320, 352), (96, 128, 160),
                          max_tokens=32)
    sizes = dict(gpu_blocks=160, cpu_blocks=1024, max_running=8)
    expect = MOE_SWAPS if cfg.name == MOE_ARCH else None
    with swaps_follow_the_clock(), replays_held_to_eager() as held, \
            fullest_replays() as snaps:
        warm, warm_wall, _, warm_swaps = run_engine(bundle, convs, **sizes)
    check_engine(warm, convs, warm_swaps, expect_swaps=expect)
    if not held:
        raise AssertionError("no captured MoE decode step was replayed")
    kernels = _serving_kernels()
    kl.reset(*kernels.values())
    with swaps_follow_the_clock() as hold:
        eng, wall, host, swaps = run_engine(bundle, convs, **sizes)
    launched = {n: fn.launches for n, fn in kernels.items()}
    stats = check_engine(eng, convs, swaps, expect_swaps=expect)
    if cuda and min(launched.values()) <= 0:
        raise AssertionError(f"a kernel of the MoE path never launched: "
                             f"{launched}")
    if cuda and launched["paged_attention"] != \
            cfg.n_layers * stats["decode_steps"]:
        raise AssertionError(f"paged attention counted "
                             f"{launched['paged_attention']} times over "
                             f"{stats['decode_steps']} decode steps of "
                             f"{cfg.n_layers} layers")
    if eng._token_hist_by_conv != warm._token_hist_by_conv:
        raise AssertionError("the warm-up and the timed MoE runs gave other "
                             "tokens")
    # the same workload with swap tasks left to the threads, as
    # launch.serve runs it: its wall, and every turn finished (its tokens
    # may differ, since thread timing then picks which rows decode
    # together)
    free, free_wall, free_host, free_swaps = run_engine(bundle, convs,
                                                        **sizes)
    free_tokens = check_engine(free, convs, free_swaps)["tokens"]
    del free
    if cuda:
        mem["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    bucket = (eng.runner.batch_bucket, eng.runner._pages_bucket)
    snap = snaps.get(bucket) or max(snaps.values(), key=lambda s: s["active"])
    oracle = moe_oracle(eng, snap)
    # one replay of the last bucket's argmax-only graph over its fullest
    # state (each replay advances the rows; the engine is done with them)
    live = eng.runner._step_tensors(eng.pools.gpu)
    replay = {"bucket": list(bucket), "active_rows": snap["active"]}
    graph = None
    if cuda and all(a.shape == b.shape for a, b in zip(live, snap["clones"])):
        for a, b in zip(live, snap["clones"]):
            a.copy_(b)
        ctx = snap["clones"][dr.STEP_TENSORS.index("context_lens")]
        b_ms, b_by = bound_ms(moe_step_bytes(
            bundle["params"], cfg, ctx, oracle["routed_experts_per_layer"]),
            0)
        dense_ms, _ = bound_ms(moe_step_bytes(bundle["params"], cfg, ctx), 0)
        graph = eng.runner._graphs[False].graph
        replay.update(ms=time_ms(graph.replay), bound_ms=b_ms, bound_by=b_by,
                      dense_bound_ms=dense_ms)
        replay["bound_share"] = replay["bound_ms"] / replay["ms"]
        replay["dense_bound_share"] = dense_ms / replay["ms"]
        if profile:
            replay["profile"] = replay_ops(graph.replay)
        # a staged swap-in from a worker thread beside one such replay
        for a, b in zip(live, snap["clones"]):
            a.copy_(b)
        replay["beside_swap_in"] = overlap_probe(graph.replay, device)
    out = {"arch": cfg.name, "wall_s": wall, "warm_wall_s": warm_wall,
           "init_s": init_s, "tokens_per_s": stats["tokens"] / wall,
           "host_s_by_method": host,
           "earlier_staged_s": EARLIER_STAGED_S.get(cfg.name),
           "clock_hold_wait_s": hold["wait_s"],
           "unheld_wall_s": free_wall,
           "unheld_tokens_per_s": free_tokens / free_wall,
           "unheld_host_s_by_method": free_host, "launches": launched,
           "replays_checked": held, "replay": replay, "memory": mem,
           "determinism": "warm-up and timed runs: equal token histories",
           "oracle": oracle, **stats}
    del eng, warm, snaps, snap, live, bundle, graph
    if cuda:
        # the engines' timed methods wrap bound methods of their own
        # runner and pools (reference cycles): collect them, and the
        # weights they hold, before the launcher's process needs the card
        gc.collect()
        torch.cuda.empty_cache()
        out["memory"]["before_launcher_gb"] = \
            torch.cuda.memory_allocated() / 1e9
    run = run_launcher(["--real", "--arch", MOE_ARCH, "--device", kind,
                        "--conversations", "2", "--policy", "fastswitch"],
                       out_dir)
    r = run["results"]["fastswitch"]
    if cuda and min(r["kernel_launches"].values()) <= 0:
        raise AssertionError(f"serve --arch {MOE_ARCH}: a kernel never "
                             f"launched: {r['kernel_launches']}")
    out["launcher"] = {"wall_s": run["wall_s"],
                       "total_tokens": r["total_tokens"],
                       "preemptions": r["preemptions"],
                       "callstack_wall_s": r["callstack_wall_s"],
                       "kernel_launches": r["kernel_launches"],
                       "stdout": run["stdout"][-2:]}
    return out


def phase_alone(phase: str, timeout: float = 900.0) -> dict:
    """The ``phase`` phase in a process of its own,
    ``scripts/{phase}_probe.py`` (which builds nothing new: the kernels'
    libraries are cached under ``build/``), so that nothing the phase
    leaves in a process (tens of GB of allocations freed, dead runners'
    CUDA graphs, swap threads) precedes phase 6's profiler sessions.
    Returns the probe's ``{"phase": phase, ...}`` line without its
    ``phase`` key; raises with its standard error where it exits
    non-zero."""
    run = subprocess.run([sys.executable,
                          str(ROOT / "scripts" / f"{phase}_probe.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    if run.returncode != 0:
        raise AssertionError(f"the {phase} phase exited {run.returncode}: "
                             f"{run.stderr[-4000:]}")
    out = json.loads(next(line for line in run.stdout.splitlines()
                          if line.startswith(f'{{"phase": "{phase}"')))
    out.pop("phase")
    return out


# ---------------------------------------------------------------------------
# phase 5h: training and the contiguous-cache step functions (qwen2-1.5b)
# ---------------------------------------------------------------------------

# the card against the CPU, the same params and batch at 2 layers: bf16
# products accumulate in other orders in cuBLAS and on the CPU, and each
# rounds its output to bf16, so activations and cotangents differ by
# ulps as the port's and the reference's do on the CPU (per gradient
# leaf, relative L2 0.004-0.017 there, the reference against itself up
# to 0.020; tests/test_torch_train.py holds 4e-2).  The loss is a mean of
# fp32 log-probabilities (there within 2.6e-5 relative; held to 1e-3 over
# the 1536-wide, 151936-way products here).
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_RTOL = 4e-2
# Some configurations are far more sensitive to rounding than others:
# at random weights and full width, rwkv6-1.6b's time-mix gradients
# (u_bonus, w_r, w_k, mu_base) move 10-18 % (relative L2) when the
# embedding table is scaled by 1 + 1e-4 N(0, 1), a fortieth of a bf16
# ulp, where zamba2's one period moves at most 4 %; the card and the CPU
# round bf16 products apart by whole ulps, so such leaves lie 9-19 %
# apart there (H100 80GB HBM3, 700.00 W; the ssm phase's
# ``conditioning`` and ``grad_rel_l2``).  A leaf is held to its fixed
# bound, or to COND_FACTOR times its own change under that perturbation
# of the CPU run (``conditioning``), the larger: the check follows the
# function's conditioning, measured in the same run, not the card's.
COND_EPS = 1e-4
COND_FACTOR = 2.0
# remat on against off on one device: the same operations recomputed, so
# only a reduction order that depends on the memory layout could move a
# gradient (fp32 re-association)
REMAT_GRAD_RTOL = 1e-6


def _rel_l2(got, want) -> float:
    import torch
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.clamp(torch.linalg.vector_norm(want), min=1e-30))


def _grad_errors(got, want) -> dict:
    """Per-leaf relative L2 error of the gradient tree ``got`` (moved to
    ``want``'s device) against ``want``, by path."""
    from repro_torch.train.checkpoint import keyed_leaves
    w = dict(keyed_leaves(want))
    return {k: _rel_l2(g.to(w[k].device), w[k])
            for k, g in keyed_leaves(got)}


def conditioning(params, cfg, data, grads) -> dict:
    """Per gradient leaf, its relative L2 change when the embedding table
    of ``params`` is scaled by 1 + ``COND_EPS`` N(0, 1) (seeded): how far
    rounding far below a bf16 ulp moves it.  ``grads``: the unperturbed
    gradients of ``loss_and_grads(params, cfg, data)``."""
    import torch
    from repro_torch.models import steps as S
    table = params["embed"]["table"]
    noise = torch.randn(table.shape, generator=torch.Generator(
        table.device).manual_seed(SEED)).to(table.device)
    moved = dict(params, embed={"table": table * (1 + COND_EPS * noise)})
    return _grad_errors(S.loss_and_grads(moved, cfg, data)[1], grads)


def device_vs_cpu(cfg, device, batch, grad_rtol: float) -> dict:
    """``loss_and_grads`` (remat on) of ``cfg`` on ``device`` against the
    CPU, the same params (drawn on the CPU) and a batch of ``batch`` (B,
    T): the loss within ``TRAIN_LOSS_RTOL`` (relative) and each gradient
    leaf within ``grad_rtol`` or ``COND_FACTOR`` times its
    ``conditioning``, the larger (relative L2)."""
    import torch
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import tree_map
    dev = torch.device(device)
    cpu_params = T.init_params(cfg, seed=SEED, device="cpu")
    B, T_len = batch
    data = _train_batch(cfg, B, T_len, "cpu", seed=SEED + 2)
    cl, cg = S.loss_and_grads(cpu_params, cfg, data)
    cond = conditioning(cpu_params, cfg, data, cg)
    dev_params = tree_map(lambda t: t.to(dev), cpu_params)
    dl, dg = S.loss_and_grads(dev_params, cfg,
                              {k: v.to(dev) for k, v in data.items()})
    loss_rel = abs(float(dl) - float(cl)) / abs(float(cl))
    errs = _grad_errors(dg, cg)
    bounds = {k: max(grad_rtol, COND_FACTOR * cond[k]) for k in errs}
    worst = max(errs, key=lambda k: errs[k] / bounds[k])
    if loss_rel > TRAIN_LOSS_RTOL or errs[worst] > bounds[worst]:
        raise AssertionError(
            f"{dev.type} against the CPU, {cfg.name} at {cfg.n_layers} "
            f"layers: loss {float(dl)} / {float(cl)} (relative {loss_rel}, "
            f"bound {TRAIN_LOSS_RTOL}); gradient {worst} relative L2 "
            f"{errs[worst]} (bound {bounds[worst]}: {grad_rtol}, or "
            f"{COND_FACTOR} x its change {cond[worst]} under the "
            "embedding's perturbation)")
    out = {"layers": cfg.n_layers, "params": T.count_params(cfg),
           "batch": [B, T_len], "loss": float(dl), "cpu_loss": float(cl),
           "loss_rel": loss_rel, "max_grad_rel_l2": max(errs.values()),
           "worst_leaf": max(errs, key=errs.get),
           "worst_leaf_by_bound": worst, "grad_rel_l2": errs,
           "conditioning": cond,
           "raised_bounds": {k: b for k, b in bounds.items()
                             if b > grad_rtol},
           "tolerance": {"loss_rel": TRAIN_LOSS_RTOL,
                         "grad_rel_l2": grad_rtol,
                         "conditioning_eps": COND_EPS,
                         "conditioning_factor": COND_FACTOR}}
    del cpu_params, dev_params, cg, dg
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _train_batch(cfg, B: int, T: int, device, seed: int = SEED) -> dict:
    """(B, T + 1) uniform tokens from a seeded generator on the CPU,
    moved to ``device``: tokens the first T, labels the last T; for an
    encoder-decoder also its encoder frames (``_frames``)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    base = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen)
    batch = {"tokens": base[:, :-1].to(device),
             "labels": base[:, 1:].to(device)}
    if cfg.encoder_decoder:
        batch["encoder_frames"] = _frames(cfg, B, device, seed)
    return batch


def _frames(cfg, B: int, device, seed: int = SEED):
    """Whisper's stub frontend output: (B, S_enc, d) precomputed frame
    embeddings, 0.5 N(0, 1) from a seeded generator on the CPU (the
    reference's encoder takes such embeddings; its audio frontend is a
    stub too), moved to ``device``; None for other configs."""
    import torch
    if not cfg.encoder_decoder:
        return None
    gen = torch.Generator().manual_seed(seed + 7)
    return (0.5 * torch.randn((B, cfg.n_encoder_tokens, cfg.d_model),
                              generator=gen)).to(device)


def cut_depth(cfg, n_layers: int):
    """``cfg`` at its width with ``n_layers`` layers (an encoder-decoder:
    that many encoder and decoder layers)."""
    import dataclasses
    extra = {"n_encoder_layers": n_layers} if cfg.encoder_decoder else {}
    return dataclasses.replace(cfg, n_layers=n_layers, **extra)


def matmul_weights(cfg) -> tuple:
    """(weights one token is multiplied by in a forward, the head
    included, each as often as it is applied; layers with attention):
    zamba2's shared block counts once per period; rwkv's LoRA factors
    count, its decays and mixes do not."""
    from repro_torch.models import mamba2
    from repro_torch.models import transformer as T
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    attn = d * nq + 2 * d * nkv + nq * d
    pat = T._pattern(cfg)
    if pat == "zamba2":
        s, d_inner, H, _ = mamba2._dims(cfg)
        R, P, rem = T._zamba2_shape(cfg)
        proj = d * (2 * d_inner + 2 * s.state_dim + H) + d_inner * d
        layers, n_attn = (P * R + rem) * proj + P * (attn + 3 * d
                                                     * cfg.d_ff), P
    elif pat == "rwkv":
        r = cfg.rwkv.decay_lora_rank
        layers = L * (6 * d * d + 12 * r * d + 2 * d * cfg.d_ff)
        n_attn = 0
    else:
        layers, n_attn = L * (attn + 3 * d * cfg.d_ff), L
    return layers + cfg.vocab_size * d, n_attn


def train_flops(cfg, B: int, T: int) -> dict:
    """A training step's model FLOPs (PaLM's count: 6 per matmul weight
    and token, ``matmul_weights``, plus 12 * width * T per token for the
    attention scores and values of each layer with attention; an
    encoder-decoder's encoder frames and cross attention counted the
    same way; an SSM
    scan's FLOPs, under 1 % of its layer's products at these widths, are
    left out), and the CE product's FLOPs as computed, over the positions
    padded to ``CE_CHUNK``."""
    from repro_torch.models.steps import CE_CHUNK
    nq = cfg.n_heads * cfg.resolved_head_dim
    tokens = B * T
    if cfg.encoder_decoder:
        # the encoder's B x S_enc frames and each decoder layer's cross
        # K/V projections of them; the decoder's tokens through self
        # attention, the cross queries and output, the MLP and the head
        d, f, S_enc = cfg.d_model, cfg.d_ff, cfg.n_encoder_tokens
        n_enc, n = cfg.n_encoder_layers, cfg.n_layers
        frames = B * S_enc
        model = (6 * frames * (n_enc * (4 * d * d + 2 * d * f)
                               + n * 2 * d * d)
                 + 6 * tokens * (n * (6 * d * d + 2 * d * f)
                                 + cfg.vocab_size * d)
                 + 12 * n_enc * nq * S_enc * frames
                 + 12 * n * nq * (T + S_enc) * tokens)
    else:
        matmul, n_attn = matmul_weights(cfg)
        model = 6 * matmul * tokens + 12 * n_attn * nq * T * tokens
    padded = B * (-(-T // CE_CHUNK) * CE_CHUNK)
    return {"model_flops": model,
            "ce_flops_as_computed": 6 * padded * cfg.d_model
            * cfg.vocab_size}


# host operations that wait for the card
HOST_WAITS = ("aten::_local_scalar_dense", "aten::nonzero",
              "cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def profile_step(fn, top: int = 8) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall to a
    synchronise, the device's busy ms (its kernels and copies merged into
    intervals) and idle share, the count of device operations, the host
    operations that wait for the card (``HOST_WAITS``; the synchronise
    that ends the call and the profiler's own are among them), and the
    device operations by total time.  The profiler slows the host, so the idle
    share is an upper bound.  Where the session comes back without
    device events (seen on this machine; cause not found) the reading is
    ``not_measured``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = _device_events(prof)
    if not dev:
        return {"not_measured": "the profiler recorded no device event"}
    busy = busy_seconds((e.time_range.start, e.time_range.end) for e in dev)
    waits = {}
    for e in prof.events():
        if e.name in HOST_WAITS:
            waits[e.name] = waits.get(e.name, 0) + 1
    by_name = {}
    for e in dev:
        n_us = by_name.setdefault(e.name[:80], [0, 0.0])
        n_us[0] += 1
        n_us[1] += e.time_range.end - e.time_range.start
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
            "device_idle_share": 1.0 - busy / wall,
            "device_ops": len(dev), "host_waits": waits,
            "top_device_ops": [{"name": n, "count": c, "ms": us / 1e3}
                               for n, (c, us) in ranked]}


def contiguous_decode(params, cfg, prompts, cache_len: int, n_steps: int,
                      kv_dtype=None, frames=None):
    """Greedy decode of ``prompts`` (B, P) through the contiguous-cache
    step functions (an encoder-decoder against ``frames``): bf16 caches
    are filled by ``prefill`` and ``caches_from_prefill``; an int8 cache
    (``kv_dtype``) by one ``serve_step`` per prompt token from
    ``init_caches``, since only ``serve_step`` quantises (whisper's bf16
    cross K/V taken from a prefill).  Then ``n_steps`` ``serve_step``s.
    Returns (histories (B, P + 1 + n_steps), every step's logits finite)."""
    import torch
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T
    B, P = prompts.shape
    if kv_dtype is None:
        last, raw = S.prefill(params, cfg, prompts, encoder_frames=frames)
        caches = S.caches_from_prefill(cfg, raw, B, cache_len)
    else:
        caches = T.init_caches(cfg, B, cache_len, kv_dtype=kv_dtype,
                               device=prompts.device)
        if cfg.encoder_decoder:
            _, raw = S.prefill(params, cfg, prompts[:, :1],
                               encoder_frames=frames)
            caches = caches._replace(cross_k=raw[2], cross_v=raw[3])
        for i in range(P):
            _, last, caches = S.serve_step(params, caches, prompts[:, i], i,
                                           cfg=cfg)
    finite = bool(torch.isfinite(last).all())
    tok = torch.argmax(last, dim=-1)
    out = [tok]
    for i in range(n_steps):
        tok, logits, caches = S.serve_step(params, caches, tok, P + i,
                                           cfg=cfg)
        finite = finite and bool(torch.isfinite(logits).all())
        out.append(tok)
    return torch.cat([prompts, torch.stack(out, 1).to(prompts.dtype)],
                     1), finite


def train_phase(device, cfg=None, batch=(8, 128), steps: int = 8,
                decode=(8, 256, 32, 512), cpu_check=(2, 64),
                lr: float = 3e-4) -> dict:
    """qwen2-1.5b at full width (``cfg``: another config, also one of the
    other phases' archs, or a reduced one for a rehearsal on the CPU)
    through ``models/steps.py`` and ``train/optimizer.py`` (an
    encoder-decoder's batches and decode with seeded encoder frames,
    ``_frames``):

      * overfit: ``steps`` ``train_step``s (remat on, learning rate
        ``lr``) on one fixed batch of ``batch`` (B, T); every loss
        finite, the last below the first;
      * remat: ``loss_and_grads`` with remat on and off from one state;
        equal losses, every gradient leaf within ``REMAT_GRAD_RTOL``
        (byte equality reported);
      * the card against the CPU: the config at 2 layers (an
        encoder-decoder: 2 + 2), the same params
        (drawn on the CPU) and a batch of ``cpu_check`` (B, T): the loss
        within ``TRAIN_LOSS_RTOL`` and every gradient leaf within
        ``TRAIN_GRAD_RTOL`` or twice its change under a 1e-4 perturbation
        of the embedding (``device_vs_cpu``; relative L2);
      * contiguous decode: ``decode`` = (B, prompt, steps, cache_len):
        ``prefill`` -> ``caches_from_prefill`` -> ``serve_step``s, every
        greedy token the dense forward's argmax or a near-tie
        (``check_history``); where the caches hold attention K/V (not
        rwkv's), the same with an int8 cache, its logits finite and its
        agreement with the bf16 tokens reported;
      * the launcher ``python -m repro_torch.launch.train --arch ARCH
        --steps 5 --batch B --seq T`` as a subprocess (``--device cpu``
        with a CPU ``device``: the reduced config), exit 0.

    On CUDA also the step's median ms, tokens/s, model FLOPs and their
    share of the bf16 peak, the ms in ``loss_and_grads`` and in
    ``adamw_update`` (CUDA events), the CE product's ms (forward and
    backward at the step's shape), one step under ``torch.profiler``
    (``profile_step``) and the peak memory of a step with remat on and
    off."""
    import dataclasses
    import os
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import adamw_update, tree_leaves
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = cfg or get_config(ARCH)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {"arch": cfg.name, "batch": list(batch)}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params, opt = S.init_train_state(cfg, seed=SEED, device=dev)
    out["params"] = sum(t.numel() for t in tree_leaves(params))
    B, T_len = batch
    data = _train_batch(cfg, B, T_len, dev)

    # overfit one batch, remat on
    losses, step_s = [], []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        params, opt, loss = S.train_step(params, opt, data, cfg=cfg, lr=lr)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"a training loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall over {steps} steps on "
                             f"one batch: {losses}")
    out["overfit_losses"] = losses
    out["lr"] = lr
    if cuda:
        out["memory"] = {"peak_remat_on_gb":
                         torch.cuda.max_memory_allocated() / 1e9}

    # remat on against off, from the same state
    l1, g1 = S.loss_and_grads(params, cfg, data, remat=True)
    l0, g0 = S.loss_and_grads(params, cfg, data, remat=False)
    if float(l1) != float(l0):
        raise AssertionError(f"remat changed the loss: {float(l1)} against "
                             f"{float(l0)}")
    errs = _grad_errors(g1, g0)
    worst = max(errs, key=errs.get)
    if errs[worst] > REMAT_GRAD_RTOL:
        raise AssertionError(f"remat moved gradient {worst} by "
                             f"{errs[worst]} (> {REMAT_GRAD_RTOL})")
    out["remat"] = {"loss_equal": True, "max_grad_rel_l2": errs[worst],
                    "tolerance": REMAT_GRAD_RTOL,
                    "byte_equal": all(torch.equal(a, b) for a, b in zip(
                        tree_leaves(g1), tree_leaves(g0)))}
    del g0, g1

    if cuda:
        # a step with remat off: its peak; then the step's parts
        torch.cuda.reset_peak_memory_stats()
        params, opt, _ = S.train_step(params, opt, data, cfg=cfg,
                                      remat=False)
        out["memory"]["peak_remat_off_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        parts = {"loss_and_grads": [], "adamw_update": []}
        for _ in range(3):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record()
            _, grads = S.loss_and_grads(params, cfg, data)
            marks[1].record()
            params, opt = adamw_update(grads, opt, params)
            marks[2].record()
            marks[2].synchronize()
            del grads
            parts["loss_and_grads"].append(marks[0].elapsed_time(marks[1]))
            parts["adamw_update"].append(marks[1].elapsed_time(marks[2]))
        hidden = torch.randn((B, T_len, cfg.d_model), device=dev,
                             dtype=torch.bfloat16, requires_grad=True)
        head = params["embed"]["table"].detach().requires_grad_(True)

        def ce():
            S.chunked_ce_loss(hidden, head, data["labels"]).backward()
        ce_ms = time_ms(ce, iters=5, warmup=1)
        del hidden, head

        def step():
            nonlocal params, opt
            params, opt, _ = S.train_step(params, opt, data, cfg=cfg)
        out["profile"] = profile_step(step)
        step_ms = sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3
        flops = train_flops(cfg, B, T_len)
        out.update(
            step_ms=step_ms, step_ms_all=[s * 1e3 for s in step_s],
            tokens_per_s=B * T_len / (step_ms / 1e3), **flops,
            model_flops_share=flops["model_flops"] / (step_ms / 1e3)
            / BF16_FLOPS_S,
            loss_and_grads_ms=sorted(parts["loss_and_grads"])[1],
            adamw_update_ms=sorted(parts["adamw_update"])[1],
            ce_fwd_bwd_ms=ce_ms)

    # contiguous decode, bf16 and int8 caches, on the trained params
    nb, plen, n_steps, cache_len = decode
    gen = torch.Generator().manual_seed(SEED + 1)
    prompts = torch.randint(1, cfg.vocab_size, (nb, plen),
                            generator=gen).to(dev)
    frames = _frames(cfg, nb, dev, SEED + 1)
    hist, finite = contiguous_decode(params, cfg, prompts, cache_len,
                                     n_steps, frames=frames)
    if not finite:
        raise AssertionError("the bf16 cache's decode gave logits that are "
                             "not finite")
    bundle = {"params": params, "cfg": cfg}
    gen_pos = list(range(plen, plen + n_steps + 1))
    rows = [check_history(bundle, h.tolist(), gen_pos,
                          frames=None if frames is None else frames[i:i + 1])
            for i, h in enumerate(hist)]
    out["decode"] = {
        "rows": nb, "prompt": plen, "steps": n_steps,
        "cache_len": cache_len,
        "generated": sum(r["generated"] for r in rows),
        "equal": sum(r["equal"] for r in rows),
        "near_ties": sum(r["near_ties"] for r in rows),
        "max_gap": max(r["max_gap"] for r in rows), "tolerance": NEAR_TIE}
    if T._pattern(cfg) != "rwkv":
        hist8, finite8 = contiguous_decode(params, cfg, prompts, cache_len,
                                           n_steps, kv_dtype=torch.int8,
                                           frames=frames)
        if not finite8:
            raise AssertionError("the int8 cache's decode gave logits that "
                                 "are not finite")
        same = (hist8[:, plen:] == hist[:, plen:])
        out["decode"]["int8"] = {
            "finite": True, "tokens_equal_bf16": int(same.sum()),
            "rows_equal_bf16": int(same.all(1).sum()),
            "first_diff_by_row": [int(r.nonzero()[0, 0]) if r.any()
                                  else None for r in ~same]}
    del params, opt, bundle, data, frames

    # the card against the CPU, 2 layers at the config's width (an
    # encoder-decoder: 2 encoder and 2 decoder layers)
    out["device_vs_cpu"] = device_vs_cpu(cut_depth(cfg, 2), dev, cpu_check,
                                         TRAIN_GRAD_RTOL)

    # the launcher, as a subprocess
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           cfg.name.removesuffix("-smoke"), "--steps", "5", "--batch",
           str(B), "--seq", str(T_len), "--device", dev.type]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited "
                             f"{run.returncode}: {run.stderr[-2000:]}")
    lines = run.stdout.splitlines()
    if not any(ln.startswith("step     4 loss") for ln in lines):
        raise AssertionError(f"the launcher printed no last step: {lines}")
    out["launcher"] = {"argv": cmd[2:], "wall_s": time.perf_counter() - t0,
                       "stdout": lines}
    return out


# ---------------------------------------------------------------------------
# phase 5i: the SSM and hybrid families (zamba2-7b served, rwkv6-1.6b
# trained)
# ---------------------------------------------------------------------------

SSM_ARCH, RWKV_ARCH = "zamba2-7b", "rwkv6-1.6b"
# zamba2-7b at random weights amplifies rounding: two plain prefills that
# differ only in the fp32 summation order of their scans (the kernel's
# plain twin and ``gla_chunked``) end 0.37 apart in the last logits (mean
# 0.058, logits of std 1.2; H100 80GB HBM3, 700.00 W, this phase's
# ``plain_vs_chunked``).  So the kernel's prefill is held to that spread,
# measured in the same run without the kernel: its last logits against
# the plain twin's within SSM_SPREAD_FACTOR times the two plain
# prefills' distance, per element and on the mean (a scan off by a chunk
# or a head moves the mean by O(1)); and a decoded token the dense
# forward disagrees with is accepted within SSM_SPREAD_FACTOR times the
# two plain dense forwards' largest logit distance at the generated
# positions, and never less than NEAR_TIE
SSM_SPREAD_FACTOR = 2.0
@contextlib.contextmanager
def chunked_scan():
    """Inside the block the Mamba2 blocks run ``gla_chunked`` on CUDA
    too: the scan in plain torch, in another fp32 summation order than
    the kernel's plain twin."""
    from repro_torch.models import gla, mamba2
    real = mamba2.ssd_scan
    mamba2.ssd_scan = lambda q, k, v, logw, cfg, state: gla.gla_chunked(
        q, k, v, logw, mode="mamba", chunk=min(cfg.ssm.chunk_size,
                                              q.shape[2]),
        scalar_decay=True)
    try:
        yield
    finally:
        mamba2.ssd_scan = real


@contextlib.contextmanager
def plain_scan():
    """Inside the block the Mamba2 blocks' scan runs the kernel's plain
    version (``ops.gla_scan_scalar`` replaced by
    ``gla_scan_scalar_plain``), the same function with no kernel."""
    from repro_torch.kernels import gla_scan as gla
    from repro_torch.kernels import ops
    real = ops.gla_scan_scalar
    ops.gla_scan_scalar = lambda q, k, v, logw, *, chunk=64: \
        gla.gla_scan_scalar_plain(q, k, v, logw, chunk=chunk)
    try:
        yield
    finally:
        ops.gla_scan_scalar = real


def first_scan_inputs(params, cfg, toks):
    """(q, k, v, logw) the first Mamba2 layer of a zamba2 forward hands
    its scan for ``toks``: q and k broadcast across heads, as
    ``mamba2._ssd_inputs`` makes them."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2
    lp = {k: {n: t[0, 0] for n, t in v.items()}
          for k, v in params["mamba_p"].items()}
    p = lp["mamba"]
    with torch.no_grad():
        h = L.rmsnorm(lp["ln"], L.embed(params["embed"], toks), cfg.norm_eps)
        z, xbc, dt_raw = mamba2._split_proj(h @ p["w_in"].to(h.dtype), cfg)
        prev = xbc.new_zeros((xbc.shape[0], cfg.ssm.conv_kernel - 1,
                              xbc.shape[2]))
        xbc, _ = mamba2._causal_conv(xbc, p["conv_w"], p["conv_b"], prev)
        return mamba2._ssd_inputs(p, xbc, dt_raw, cfg)[:4]


def decode_step_bytes(params, caches) -> float:
    """Bytes one contiguous-cache decode step must move: every parameter
    read once but the embedding table (a row per sequence, left out), the
    caches read and the new caches written."""
    nbytes = sum(t.numel() * t.element_size()
                 for name, sub in params.items() if name != "embed"
                 for t in _leaves(sub))
    cache = sum(t.numel() * t.element_size() for t in caches)
    return float(nbytes + 2 * cache)


def zamba2_serve(device, cfg, prompts=(8, 256), n_steps: int = 32,
                 cache_len: int = 512) -> dict:
    """zamba2 at ``cfg``'s width from a seeded init, its bf16 serving copy
    only (the fp32 matmul leaves are dropped once cast):

      * ``prompts`` (B, T) through ``steps.prefill`` after a warm-up
        prefill, the scan's launch count set to 0 just before: one launch
        per Mamba2 layer on CUDA (none on the CPU, where the blocks run
        ``gla_chunked``);
      * the same prefill with the kernel's plain version (``plain_scan``)
        and with ``gla_chunked`` (``chunked_scan``): the kernel's last
        logits within ``SSM_SPREAD_FACTOR`` times the two plain
        prefills' distance of the plain twin's (per element and on the
        mean); the first layer's scan y and S within phase 3's bounds
        (``gla_errors``);
      * ``caches_from_prefill`` to ``cache_len`` positions and
        ``n_steps`` greedy ``serve_step``s, every token the dense
        forward's argmax or a near-tie (``check_history``) within
        ``SSM_SPREAD_FACTOR`` times the two plain dense forwards'
        largest logit distance at the generated positions (at least
        ``NEAR_TIE``).
    On CUDA also the prefill's and a decode step's ms, the scan kernel's
    ms and device ms at the prefill's shape beside its bound and its plain
    version, one decode step under ``torch.profiler`` (its device
    operations: the launches it makes; busy ms and idle share), the decode
    step's bound (``decode_step_bytes``) and peak memory."""
    import torch
    from repro_torch.kernels import gla_scan as gla
    from repro_torch.kernels import launches as lc
    from repro_torch.models import mamba2
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev, serving=True)
    sync()
    R, P, rem = T._zamba2_shape(cfg)
    n_mamba = P * R + rem
    out = {"arch": cfg.name, "params": T.count_params(cfg),
           "mamba2_layers": n_mamba, "init_s": time.perf_counter() - t0}
    B, plen = prompts
    gen = torch.Generator().manual_seed(SEED + 3)
    toks = torch.randint(1, cfg.vocab_size, (B, plen), generator=gen).to(dev)

    S.prefill(params, cfg, toks)                 # warm-up
    sync()
    lc.reset(gla.gla_scan_scalar)
    t0 = time.perf_counter()
    last, raw = S.prefill(params, cfg, toks)
    sync()
    prefill_s = time.perf_counter() - t0
    launched = gla.gla_scan_scalar.launches
    if launched != (n_mamba if cuda else 0):
        raise AssertionError(f"a {cfg.name} prefill launched the scan "
                             f"kernel {launched} times over {n_mamba} "
                             "Mamba2 layers")
    out["prefill"] = {"batch": [B, plen], "scan_launches": launched}
    with plain_scan():
        plain_last, _ = S.prefill(params, cfg, toks)
    with chunked_scan():
        chunked_last, _ = S.prefill(params, cfg, toks)
    diff = (last - plain_last).abs()
    err, mean = float(diff.max()), float(diff.mean())
    spread = (chunked_last - plain_last).abs()
    bound = SSM_SPREAD_FACTOR * float(spread.max())
    mean_bound = SSM_SPREAD_FACTOR * float(spread.mean())
    if not (math.isfinite(err) and err <= bound and mean <= mean_bound):
        raise AssertionError(f"{cfg.name} prefill, the scan kernel against "
                             f"its plain version: last logits max abs "
                             f"{err}, mean {mean} (bounds {bound}, "
                             f"{mean_bound}: {SSM_SPREAD_FACTOR} x the two "
                             "plain prefills' distance)")
    q, k, v, logw = first_scan_inputs(params, cfg, toks)
    y, s = mamba2.ssd_scan_kernel(q, k, v, logw, cfg.ssm.chunk_size)
    with plain_scan():
        py, ps = mamba2.ssd_scan_kernel(q, k, v, logw, cfg.ssm.chunk_size)
    sync()
    y_err, s_err = gla_errors(y, s, py, ps)
    out["kernel_vs_plain"] = {
        "last_logits_max_abs": err, "last_logits_mean_abs": mean,
        "plain_vs_chunked": {"max_abs": float(spread.max()),
                             "mean_abs": float(spread.mean())},
        "tolerance": {"max": bound, "mean": mean_bound,
                      "factor": SSM_SPREAD_FACTOR},
        "logits_std": float(plain_last.std()),
        "first_layer_scan": {"y": y_err, "S": s_err},
        "scan_tolerance": {"y": {"atol": GLA_Y_ATOL, "rtol": ATTN_RTOL},
                           "S": {"atol": GLA_S_ATOL, "rtol": GLA_S_RTOL}}}

    caches = S.caches_from_prefill(cfg, raw, B, cache_len)
    del raw
    tok = torch.argmax(last, dim=-1)
    hist, step_s, finite = [toks, tok[:, None]], [], True
    for i in range(n_steps):
        sync()
        t0 = time.perf_counter()
        tok, logits, caches = S.serve_step(params, caches, tok, plen + i,
                                           cfg=cfg)
        sync()
        step_s.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(logits).all())
        hist.append(tok[:, None].to(toks.dtype))
    if not finite:
        raise AssertionError(f"{cfg.name}: a decode step's logits are not "
                             "finite")
    hist = torch.cat(hist, 1)
    bundle = {"params": params, "cfg": cfg}
    gen_pos = list(range(plen, plen + n_steps + 1))
    with torch.no_grad():
        at = [i - 1 for i in gen_pos]                  # the logits there
        with plain_scan():
            a = T.forward_seq(params, cfg, hist)[0][:, at]
        with chunked_scan():
            b = T.forward_seq(params, cfg, hist)[0][:, at]
        dense_spread = float((a - b).abs().max())
        del a, b
    tol = max(NEAR_TIE, SSM_SPREAD_FACTOR * dense_spread)
    rows = [check_history(bundle, h.tolist(), gen_pos, tol) for h in hist]
    out["decode"] = {
        "rows": B, "prompt": plen, "steps": n_steps, "cache_len": cache_len,
        "generated": sum(r["generated"] for r in rows),
        "equal": sum(r["equal"] for r in rows),
        "near_ties": sum(r["near_ties"] for r in rows),
        "max_gap": max(r["max_gap"] for r in rows),
        "dense_plain_vs_chunked_max_abs": dense_spread, "tolerance": tol}
    if cuda:
        step_ms = sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3
        b_ms, b_by = bound_ms(decode_step_bytes(params, caches), 0)
        out["prefill"].update(ms=prefill_s * 1e3,
                              tokens_per_s=B * plen / prefill_s)
        out["decode"].update(step_ms=step_ms,
                             step_ms_all=[t * 1e3 for t in step_s],
                             bound_ms=b_ms, bound_by=b_by,
                             bound_share=b_ms / step_ms)
        pos = plen + n_steps + 1
        out["decode"]["profile"] = profile_step(
            lambda: S.serve_step(params, caches, tok, pos, cfg=cfg))
        # the scan at the prefill's shape, as the blocks hand it over
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        lw = logw[..., 0].float().contiguous()
        chunk = mamba2.kernel_chunk(cfg.ssm.chunk_size, plen)
        flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
        timed = timings(lambda: gla.gla_scan_scalar(qc, kc, vc, lw,
                                                    chunk=chunk),
                        lambda: gla.gla_scan_scalar_plain(qc, kc, vc, lw,
                                                          chunk=chunk),
                        None, flush)
        kernel = timed.pop("fns")[0]
        N, Pd = qc.shape[-1], vc.shape[-1]
        s_ms, s_by = bound_ms(*gla_work(B, qc.shape[1], plen, N, Pd, chunk))
        out["scan_at_prefill_shape"] = {
            "shape": list(qc.shape[:3]) + [N, Pd], "chunk": chunk, **timed,
            "device_ms": queued_ms(kernel, flush=flush),
            "device_ms_by": "cuda_events", "bound_ms": s_ms,
            "bound_by": s_by}
        out["scan_at_prefill_shape"]["bound_share"] = \
            s_ms / out["scan_at_prefill_shape"]["device_ms"]
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del flush, qc, kc, vc, lw
    del params, caches, bundle, q, k, v, logw, y, s, py, ps
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    return out


def zamba2_train_cut(device, cfg, batch=(2, 64)) -> dict:
    """zamba2's ``loss_and_grads`` (remat on) at ``cfg``'s width cut to one
    period (``hybrid_attn_every`` layers: the Mamba2 layers and the shared
    block) on ``device`` against the CPU (``device_vs_cpu``, gradient
    leaves within ``TRAIN_GRAD_RTOL`` or their conditioning's bound).  A
    gradient is needed, so the blocks run ``gla_chunked`` under autograd
    and the scan kernel is launched no time (its count set to 0 just
    before the CPU's and the card's runs)."""
    import dataclasses
    from repro_torch.kernels import gla_scan as gla
    from repro_torch.kernels import launches as lc
    lc.reset(gla.gla_scan_scalar)
    out = device_vs_cpu(dataclasses.replace(
        cfg, n_layers=cfg.hybrid_attn_every), device, batch,
        TRAIN_GRAD_RTOL)
    launched = gla.gla_scan_scalar.launches
    if launched:
        raise AssertionError(f"the {cfg.name} train step launched the scan "
                             f"kernel {launched} times (it has no backward)")
    return {**out, "scan_launches": launched}


def _refusals(cases: dict) -> dict:
    """Each ``name: (argv, want)`` of ``cases`` run as ``python -m argv``,
    all as subprocesses at once; each must exit non-zero with ``want`` in
    the last line of its standard error and no traceback."""
    import os
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", *argv], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (argv, _) in cases.items()}
    out, faults = {}, []
    for name, proc in procs.items():
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        argv, want = cases[name]
        said = err.strip().splitlines()
        if proc.returncode == 0 or not said or want not in said[-1] \
                or "Traceback" in err:
            faults.append(f"{' '.join(argv)} exited {proc.returncode}: "
                          f"{err[-2000:]}")
        out[name] = {"argv": argv, "exit": proc.returncode,
                     "message": said[-1] if said else ""}
    if faults:
        raise AssertionError("; ".join(faults))
    return out


def _refusal_cases(device, arch: str) -> dict:
    """(argv, message) of the two launchers on ``arch`` where they must
    refuse: ``launch.train --device cuda`` (on CUDA: the fp32 training
    state exceeds the card; with no GPU: no CUDA) and ``launch.serve
    --real --device DEV`` (no paged path for the family: the reference's
    message)."""
    import torch
    cuda = torch.device(device).type == "cuda"
    return {
        "train": (["repro_torch.launch.train", "--arch", arch, "--steps",
                   "1", "--device", "cuda"],
                  "exceeds the card's memory" if cuda
                  else "torch.cuda.is_available() is false"),
        "serve": (["repro_torch.launch.serve", "--real", "--arch", arch,
                   "--conversations", "1", "--device",
                   "cuda" if cuda else "cpu"],
                  "real-mode serving needs a uniform GQA arch")}


def launcher_refusals(device) -> dict:
    """The launchers on zamba2-7b where they must refuse, as subprocesses
    (``_refusal_cases``)."""
    return _refusals(_refusal_cases(device, SSM_ARCH))


# the depth the ssm phase serves and trains each arch at, every width
# kept: zamba2-7b's first period and its 3 remainder layers (8 Mamba2
# layers of its 68), rwkv6-1.6b's first 4 layers of 24; chip_smoke's
# time limit holds them (the launchers run the whole models)
SSM_DEPTH = {"zamba2-7b": 9, "rwkv6-1.6b": 4}


def ssm_phase(device, zcfg=None, rcfg=None, serve=((8, 256), 32, 512),
              cut_batch=(2, 64), train=None) -> dict:
    """The SSM and hybrid families on ``device`` (at full width and
    ``SSM_DEPTH`` where the configs are not given; a rehearsal on the
    CPU passes reduced ones):

      * ``zamba2``: zamba2-7b served through the contiguous-cache steps
        (``zamba2_serve``), the SSD scan kernel once per Mamba2 layer of
        a prefill (8 at ``SSM_DEPTH``);
      * ``zamba2_train``: its train step cut to one period, against the
        CPU (``zamba2_train_cut``), no scan kernel launched;
      * ``rwkv6``: rwkv6-1.6b trained and decoded through ``train_phase``
        (``train``: its keyword arguments), its launcher as a
        subprocess;
      * ``refusals``: ``launcher_refusals``."""
    from repro_torch.configs import get_config
    zcfg = zcfg or cut_depth(get_config(SSM_ARCH), SSM_DEPTH[SSM_ARCH])
    rcfg = rcfg or cut_depth(get_config(RWKV_ARCH), SSM_DEPTH[RWKV_ARCH])
    prompts, n_steps, cache_len = serve
    parts = {
        "zamba2": lambda: zamba2_serve(device, zcfg, prompts, n_steps,
                                       cache_len),
        "zamba2_train": lambda: zamba2_train_cut(device, zcfg, cut_batch),
        "rwkv6": lambda: train_phase(device, cfg=rcfg, **(train or {})),
        "refusals": lambda: launcher_refusals(device)}
    out, part_s = {}, {}
    for name, run in parts.items():
        t0 = time.perf_counter()
        out[name] = run()
        part_s[name] = time.perf_counter() - t0
        # each part's result as it comes, on stderr: a later part's
        # failure leaves the earlier ones readable
        print(json.dumps({"ssm_part": name, "part_s": part_s[name],
                          **out[name]}), file=sys.stderr, flush=True)
    return {**out, "part_s": part_s}


# ---------------------------------------------------------------------------
# phase 5j: the last three families (gemma3-12b and deepseek-v2-236b served
# through the contiguous-cache steps, whisper-large-v3 trained)
# ---------------------------------------------------------------------------

GEMMA_ARCH, DEEPSEEK_ARCH, WHISPER_ARCH = ("gemma3-12b", "deepseek-v2-236b",
                                           "whisper-large-v3")
# deepseek-v2's layer 0 (MLA and a dense FFN): its absorbed-weight decode
# output against its sequence forward's at the same positions.  The
# absorption is exact algebra; the two round at other places (the
# sequence forward rounds K = latent @ w_uk to bf16, the decode rounds
# q @ w_uk^T), which moves the layer's output by ~1 % (relative L2 per
# row, measured on the CPU: 0.016 at the smoke config, 0.0095 at full
# width).  A head mixed up in the absorption moves it by O(1).
MLA_LAYER_RTOL = 5e-2
# whisper-large-v3's overfit steps: its decoder's output is not normed
# (the reference's model), so at random init the hidden states reach an
# rms of ~9 after 32 layers and the logits a std of ~7 (first loss 28.2
# where ln V = 10.9).  Adam's first steps move every weight by ~lr, which
# at the trainer's 3e-4 moves a logit by ~3 (1280 x 9 x 3e-4): the loss
# on one batch rose 28.2 -> 42.0 -> 211.6 and stayed above 99 for 8 steps
# (H100 80GB HBM3, 700.00 W).  At 1e-5 a step moves a logit by ~0.1.  The
# launcher's 5 steps keep the reference's 3e-4.
WHISPER_LR = 1e-5
# a MoE token routed at a near-tie: its router's K-th and (K+1)-th
# experts within this probability in the call that produced it or in the
# dense forward at its position (tests/test_torch_moe_serving.py's rule)
ROUTE_TIE = 1e-3
# gemma3's local rings after the decode against the sequence K of the
# same history: the decode's hidden states reach each layer through other
# roundings than the dense forward's (its attention reads the ring, the
# forward a masked product), so a deep layer's K lies a few bf16 ulps
# away (up to 3 ulps, 0.094 at |K| ~ 6, on the card: H100 80GB HBM3,
# 700.00 W); another position's key is an unrelated vector.  Held per
# slot by relative L2 over its layers, rows, heads and dims; the same
# reading with the ring shifted by one slot is reported beside it
RING_REL_L2 = 0.1


@contextlib.contextmanager
def attention_route(chunked: bool):
    """Within the block the sequence forwards' attention runs
    ``_sdpa_chunked`` (chunks of 1024 queries) whatever T, or one
    ``_sdpa`` over all queries: the same function in other products."""
    from repro_torch.models import attention as attn
    saved = attn.CHUNK_THRESHOLD
    attn.CHUNK_THRESHOLD = 0 if chunked else 1 << 62
    try:
        yield
    finally:
        attn.CHUNK_THRESHOLD = saved


@contextlib.contextmanager
def record_routing():
    """Within the block each MoE call records, per token, its experts (N,
    K) sorted, its K-th to (K+1)-th probability gap (N,) and whether a
    pair of it was dropped for capacity (N,), on the CPU."""
    import torch
    from repro_torch.models import moe
    calls, real = [], moe.route

    def route(router, xf, m):
        plan = real(router, xf, m)
        top = torch.sort(plan.probs, dim=-1, descending=True).values
        calls.append({"experts": plan.eids.sort(dim=-1).values.cpu(),
                      "gap": (top[:, m.top_k - 1] - top[:, m.top_k]).cpu(),
                      "dropped": (plan.slot >= plan.capacity).any(1).cpu()})
        return plan
    moe.route = route
    try:
        yield calls
    finally:
        moe.route = real


def serve_contiguous(params, cfg, toks, n_steps: int, cache_len: int,
                     sync) -> dict:
    """``toks`` (B, P) through ``steps.prefill`` (after a warm-up one),
    ``caches_from_prefill`` to ``cache_len`` positions and ``n_steps``
    greedy ``serve_step``s.  Returns the history (B, P + 1 + n_steps),
    the prefill's raw caches and last logits, the converted caches, the
    final caches, the prefill's seconds and each step's."""
    import torch
    from repro_torch.models import steps as S
    S.prefill(params, cfg, toks)                        # warm-up
    sync()
    t0 = time.perf_counter()
    last, raw = S.prefill(params, cfg, toks)
    sync()
    prefill_s = time.perf_counter() - t0
    start = S.caches_from_prefill(cfg, raw, toks.shape[0], cache_len)
    caches, tok = start, torch.argmax(last, dim=-1)
    hist, step_s, finite = [toks, tok[:, None]], [], True
    for i in range(n_steps):
        sync()
        t0 = time.perf_counter()
        tok, logits, caches = S.serve_step(params, caches, tok,
                                           toks.shape[1] + i, cfg=cfg)
        sync()
        step_s.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(logits).all())
        hist.append(tok[:, None].to(toks.dtype))
    if not (finite and bool(torch.isfinite(last).all())):
        raise AssertionError(f"{cfg.name}: a prefill's or decode step's "
                             "logits are not finite")
    return {"hist": torch.cat(hist, 1), "raw": raw, "last": last,
            "start": start, "caches": caches, "prefill_s": prefill_s,
            "step_s": step_s}


def _timing(run, B: int, plen: int) -> dict:
    steps = run["step_s"][1:] or run["step_s"]
    return {"prefill_ms": run["prefill_s"] * 1e3,
            "prefill_tokens_per_s": B * plen / run["prefill_s"],
            "step_ms": sorted(steps)[len(steps) // 2] * 1e3,
            "step_ms_all": [t * 1e3 for t in run["step_s"]]}


def _logits_at(params, cfg, hist, at):
    """The dense forward's fp32 logits at positions ``at`` of each row of
    ``hist`` (B, T): (B, len(at), V), the hidden states unembedded only
    there."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    with torch.no_grad():
        h = T.forward_seq(params, cfg, hist, return_hidden=True)[0][:, at]
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        return L.unembed(head, h)


def ring_check(cfg, rings, k_seq, upto: int, exact: bool) -> dict:
    """gemma3's local rings (P, R, B, W, Hkv, D) against the sequence K
    (P, R, B, T, Hkv, D) of the same history: slot p % W holds position p
    for the last W positions before ``upto``; ``exact`` (the prefill's
    own K moved) byte for byte, else within ``RING_REL_L2`` per slot.
    Returns the largest difference and relative L2, and the least
    relative L2 of the slots against their neighbours' positions (what
    a ring off by one slot would show); raises where a slot is off."""
    W = rings.shape[3]
    lo = max(0, upto - W)
    pos = list(range(lo, upto))
    got = rings[:, :, :, [p % W for p in pos]].float()
    want = k_seq[:, :, :, lo:upto].float()

    def rel(a, b):              # per position, over all other axes
        return ((a - b).pow(2).sum((0, 1, 2, 4, 5)).sqrt()
                / b.pow(2).sum((0, 1, 2, 4, 5)).sqrt().clamp_min(1e-30))
    per_slot = rel(got, want)
    out = {"max_abs": float((got - want).abs().max()),
           "max_rel_l2": float(per_slot.max()),
           "off_by_one_min_rel_l2": float(rel(got[:, :, :, 1:],
                                              want[:, :, :, :-1]).min())
           if len(pos) > 1 else None}
    bad = ((got != want).permute(3, 0, 1, 2, 4, 5).flatten(1).any(1)
           if exact else per_slot > RING_REL_L2)
    if bool(bad.any()):
        i = int(bad.nonzero()[0, 0])
        raise AssertionError(
            f"{cfg.name}: ring slot {pos[i] % W} does not hold position "
            f"{pos[i]} (relative L2 {float(per_slot[i])}, bound "
            f"{0.0 if exact else RING_REL_L2})")
    return out


def gemma3_serve(device, cfg, prefills=((4, 1500), (1, 5000)),
                 n_steps: int = 32) -> dict:
    """gemma3 at ``cfg``'s width from a seeded init built as its bf16
    serving copy (``init_params(serving=True)``: no fp32 tree beside it),
    for each (B, P) of ``prefills``:

      * ``serve_contiguous``: a prefill, ``caches_from_prefill`` to P +
        ``n_steps`` positions (the local rings keep the last W of a
        prompt at least W long, rolled by (P - W) % W) and ``n_steps``
        greedy ``serve_step``s, during which the rings wrap;
      * the rings after ``caches_from_prefill`` hold the prefill's K of
        position p in slot p % W byte for byte, and after the decode the
        sequence K of the whole history within ``RING_REL_L2`` per slot
        (``ring_check``);
      * every token the dense forward's argmax (its local layers windowed
        as the rings are) or a near-tie within ``SSM_SPREAD_FACTOR``
        times the distance of two plain dense forwards, through one
        ``_sdpa`` and through ``_sdpa_chunked`` (``attention_route``), at
        the generated positions, and at least ``NEAR_TIE``.
    On CUDA also the prefill's and a step's ms, one step under
    ``torch.profiler`` (its device operations: the launches a step
    makes), the step's bytes bound (``decode_step_bytes``) and the peak
    memory, after the init and over the phase."""
    import torch
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev, serving=True)
    sync()
    out = {"arch": cfg.name, "params": T.count_params(cfg),
           "init_s": time.perf_counter() - t0, "window": cfg.sliding_window}
    if cuda:
        out["init_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    bundle = {"params": params, "cfg": cfg}
    W = cfg.sliding_window
    runs = []
    for i, (B, plen) in enumerate(prefills):
        gen = torch.Generator().manual_seed(SEED + 10 + i)
        toks = torch.randint(1, cfg.vocab_size, (B, plen),
                             generator=gen).to(dev)
        run = serve_contiguous(params, cfg, toks, n_steps, plen + n_steps,
                               sync)
        hist = run["hist"]
        rec = {"batch": [B, plen], "steps": n_steps,
               "cache_len": plen + n_steps,
               "ring_slots": run["start"].local_k.shape[3],
               "ring_shift": (plen - W) % W if plen >= W else None,
               # slots the decode wrote, and how many of its writes
               # overwrote an older position (p >= W)
               "decode_slots": [plen % W, (plen + n_steps - 1) % W],
               "decode_overwrites": sum(plen + j >= W
                                        for j in range(n_steps)),
               "ring_after_prefill": ring_check(
                   cfg, run["start"].local_k, run["raw"][0], plen, True)}
        with torch.no_grad():
            k_all = T.forward_seq(params, cfg, hist[:, :-1],
                                  return_hidden=True)[1][0]
        rec["ring_after_decode"] = ring_check(
            cfg, run["caches"].local_k, k_all, plen + n_steps, False)
        del k_all
        gen_pos = list(range(plen, plen + n_steps + 1))
        at = [p - 1 for p in gen_pos]
        with attention_route(False):
            a = _logits_at(params, cfg, hist, at)
        with attention_route(True):
            b = _logits_at(params, cfg, hist, at)
        spread = float((a - b).abs().max())
        del a, b
        tol = max(NEAR_TIE, SSM_SPREAD_FACTOR * spread)
        rows = [check_history(bundle, h.tolist(), gen_pos, tol)
                for h in hist]
        rec["decode"] = {
            "generated": sum(r["generated"] for r in rows),
            "equal": sum(r["equal"] for r in rows),
            "near_ties": sum(r["near_ties"] for r in rows),
            "max_gap": max(r["max_gap"] for r in rows),
            "dense_sdpa_vs_chunked_max_abs": spread, "tolerance": tol}
        if cuda:
            rec.update(_timing(run, B, plen))
            b_ms, b_by = bound_ms(decode_step_bytes(params, run["caches"]),
                                  0)
            rec.update(step_bound_ms=b_ms, step_bound_by=b_by,
                       step_bound_share=b_ms / rec["step_ms"])
            if i == 0:
                tok = hist[:, -1]
                rec["profile"] = profile_step(
                    lambda: S.serve_step(params, run["caches"], tok,
                                         plen + n_steps, cfg=cfg))
        runs.append(rec)
        del run, hist
    out["runs"] = runs
    if cuda:
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, bundle
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_steps(device, cfg, batch=(2, 64), steps: int = 8) -> dict:
    """``steps`` ``train_step``s (remat on) of ``cfg`` from its seeded
    init on one fixed batch of ``batch`` (B, T): every loss finite, the
    last below the first.  On CUDA also the step's median ms and the
    peak memory."""
    import torch
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params, opt = S.init_train_state(cfg, seed=SEED, device=dev)
    data = _train_batch(cfg, *batch, dev)
    losses, step_s = [], []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        params, opt, loss = S.train_step(params, opt, data, cfg=cfg)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name} at {cfg.n_layers} layers: the "
                             f"losses over {steps} steps on one batch are "
                             f"{losses}")
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "params": T.count_params(cfg), "batch": list(batch),
           "losses": losses}
    if cuda:
        out.update(step_ms=sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3,
                   step_ms_all=[t * 1e3 for t in step_s],
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, opt, data
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mla_layer0_check(params, cfg, hist, start, plen: int) -> dict:
    """deepseek's layer 0 (MLA and its dense FFN) over the history
    ``hist`` (B, T): its absorbed-weight decode (``_uniform_layer_decode``
    against the layer's latent cache after ``caches_from_prefill``,
    ``start``) at each generated position against its sequence forward
    (``_uniform_layer_seq`` over the whole history) at the same
    position: per row, relative L2 within ``MLA_LAYER_RTOL``."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    B, T_len = hist.shape
    lp = params["layer0"]
    with torch.no_grad():
        x = L.embed(params["embed"], hist)
        pos = torch.arange(T_len, device=hist.device)[None].expand(B, T_len)
        seq = T._uniform_layer_seq(lp, x, cfg, pos, False)[0].float()
        cache = attn.MLACache(start.latent[0], start.k_rope[0])
        worst, worst_abs = 0.0, 0.0
        for p in range(plen, T_len):
            dec, cache = T._uniform_layer_decode(lp, x[:, p:p + 1], cfg,
                                                 cache, p, False)
            diff = dec[:, 0].float() - seq[:, p]
            rel = float((diff.norm(dim=-1) / seq[:, p].norm(dim=-1)).max())
            worst = max(worst, rel)
            worst_abs = max(worst_abs, float(diff.abs().max()))
    if not worst <= MLA_LAYER_RTOL:
        raise AssertionError(f"{cfg.name} layer 0: the absorbed decode lies "
                             f"{worst} (relative L2) from the sequence "
                             f"forward (> {MLA_LAYER_RTOL})")
    return {"positions": T_len - plen, "max_rel_l2": worst,
            "max_abs": worst_abs, "tolerance_rel_l2": MLA_LAYER_RTOL,
            "output_max_abs": float(seq.abs().max())}


def deepseek_serve(device, cfg, prompts=(4, 512), n_steps: int = 32) -> dict:
    """deepseek-v2 at ``cfg``'s width cut in depth to 2 layers (the dense
    layer 0 and one MoE layer with its shared experts), from a seeded
    bf16 serving init: ``serve_contiguous`` of ``prompts`` (B, P) and
    ``n_steps`` absorbed-weight decode steps, then

      * ``mla_layer0_check``: layer 0's decode against its sequence
        forward;
      * every token against the dense forward of its row's history with
        a capacity no pair exceeds (the decode steps drop none either:
        B rows take at most B <= 4 slots of an expert): equal; a logit
        near-tie (within ``SSM_SPREAD_FACTOR`` times the distance of two
        plain dense forwards, ``attention_route``, and at least
        ``NEAR_TIE``); a routing near-tie (the producing call and the
        dense forward chose other experts there, one of them within
        ``ROUTE_TIE``); or, for the prefill's token only, a pair of its
        position dropped for capacity in the prefill (whose capacity
        counts all B x P tokens).  Each is counted.
    On CUDA also the prefill's and a step's ms, a profiled step, the
    step's bytes bound and the peak memory."""
    import dataclasses
    import torch
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = cut_depth(cfg, 2)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev, serving=True)
    sync()
    m = cfg.moe
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "params": T.count_params(cfg),
           "experts": [m.n_experts, m.top_k, m.n_shared_experts],
           "init_s": time.perf_counter() - t0}
    B, plen = prompts
    gen = torch.Generator().manual_seed(SEED + 20)
    toks = torch.randint(1, cfg.vocab_size, (B, plen), generator=gen).to(dev)
    with record_routing() as calls:
        run = serve_contiguous(params, cfg, toks, n_steps, plen + n_steps,
                               sync)
    # calls: the warm-up prefill, the prefill, then one per step
    prefill_call, step_calls = calls[1], calls[2:]
    hist = run["hist"]
    out["layer0"] = mla_layer0_check(params, cfg, hist[:, :-1], run["start"],
                                     plen)
    dense_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    gen_pos = list(range(plen, plen + n_steps + 1))
    at = [p - 1 for p in gen_pos]
    with attention_route(False), record_routing() as dense_calls:
        a = _logits_at(params, dense_cfg, hist, at)
    with attention_route(True):
        b = _logits_at(params, dense_cfg, hist, at)
    spread = float((a - b).abs().max())
    tol = max(NEAR_TIE, SSM_SPREAD_FACTOR * spread)
    dense = dense_calls[0]                      # one MoE call, B x T rows
    T_len = hist.shape[1]
    counts = {"equal": 0, "logit_near_tie": 0, "routing_near_tie": 0,
              "prefill_capacity_drop": 0}
    worst, flips = 0.0, []
    for r in range(B):
        for j, p in enumerate(gen_pos):
            lg = a[r, j]
            want = int(hist[r, p])
            gap = float(lg.max() - lg[want])
            if gap == 0.0:
                counts["equal"] += 1
                continue
            if gap < tol:
                counts["logit_near_tie"] += 1
                worst = max(worst, gap)
                continue
            # the call that made the token: the prefill (its row's last
            # position) or decode step j - 1 (its row r)
            if j == 0:
                made = {k: v[r * plen + plen - 1] for k, v in
                        prefill_call.items()}
            else:
                made = {k: v[r] for k, v in step_calls[j - 1].items()}
            there = {k: v[r * T_len + p - 1] for k, v in dense.items()}
            if j == 0 and bool(made["dropped"]):
                counts["prefill_capacity_drop"] += 1
            elif not torch.equal(made["experts"], there["experts"]) and \
                    min(float(made["gap"]), float(there["gap"])) < ROUTE_TIE:
                counts["routing_near_tie"] += 1
                flips.append({"row": r, "position": p, "logit_gap": gap,
                              "route_gaps": [float(made["gap"]),
                                             float(there["gap"])]})
            else:
                raise AssertionError(
                    f"{cfg.name}: row {r} position {p}: the decoded token "
                    f"is {gap} below the dense maximum (>= {tol}) with "
                    f"no routing near-tie (route gaps {float(made['gap'])}, "
                    f"{float(there['gap'])}; experts "
                    f"{made['experts'].tolist()} / "
                    f"{there['experts'].tolist()})")
    del a, b
    out["decode"] = {
        "batch": [B, plen], "steps": n_steps, "cache_len": plen + n_steps,
        "generated": B * len(gen_pos), **counts,
        "max_logit_near_tie": worst, "routing_flips": flips,
        "dense_sdpa_vs_chunked_max_abs": spread,
        "tolerance": {"near_tie": tol, "route_tie": ROUTE_TIE},
        "prefill_pairs_dropped": int(prefill_call["dropped"].sum()),
        "decode_pairs_dropped": int(sum(c["dropped"].sum()
                                        for c in step_calls))}
    if out["decode"]["decode_pairs_dropped"]:
        raise AssertionError(f"{cfg.name}: a decode step dropped a pair for "
                             "capacity")
    if cuda:
        out["decode"].update(_timing(run, B, plen))
        b_ms, b_by = bound_ms(decode_step_bytes(params, run["caches"]), 0)
        out["decode"].update(step_bound_ms=b_ms, step_bound_by=b_by,
                             step_bound_share=b_ms / out["decode"]["step_ms"])
        tok = hist[:, -1]
        out["decode"]["profile"] = profile_step(
            lambda: S.serve_step(params, run["caches"], tok, plen + n_steps,
                                 cfg=cfg))
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, run, hist
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    return out


# the depth the families phase serves and trains gemma3-12b and
# whisper-large-v3 at, every width kept: gemma3's first period of its 8
# (5 local : 1 global layers), whisper's 4 + 4 layers of its 32 + 32;
# chip_smoke's time limit holds them (the train launcher runs whisper
# whole)
FAMILIES_DEPTH = {"gemma3-12b": 6, "whisper-large-v3": 4}


def families_phase(device, gcfg=None, dcfg=None, wcfg=None,
                   gemma=(((4, 1500), (1, 5000)), 32), gemma_train=(2, 64),
                   deepseek=((4, 512), 32), check=(2, 16),
                   whisper=None) -> dict:
    """The last three families on ``device`` at full width and
    ``FAMILIES_DEPTH`` where the configs are not given (a rehearsal on
    the CPU passes reduced ones):

      * ``gemma3``: gemma3-12b at one period, served through the
        contiguous-cache steps (``gemma3_serve``; ``gemma``: (prefills,
        decode steps));
      * ``gemma3_train``: its train step cut to one period (5 local + 1
        global layers, 3.36 B parameters) through ``train_steps``
        (``gemma_train``: the batch), and ``gemma3_vs_cpu``: the smoke
        config's gradients on the card against the CPU's
        (``device_vs_cpu`` at ``check``; the one-period cut's CPU run
        would need ~30 GB of host memory);
      * ``deepseek``: deepseek-v2-236b cut to 2 layers
        (``deepseek_serve``; ``deepseek``: (prompts, steps)) and
        ``deepseek_vs_cpu``: its smoke config on the card against the
        CPU;
      * ``whisper``: whisper-large-v3 at 4 + 4 layers through
        ``train_phase`` (8
        steps at B 8 x T 128, remat on against off, the card against
        the CPU at 2 + 2 layers, a prefill of 8 x 64 and 32 greedy steps
        to a 128-position cache against the dense forward, its
        launcher; the overfit steps at ``WHISPER_LR``; ``whisper``:
        train_phase's keyword arguments);
      * ``refusals``: ``launch.train --device cuda`` on gemma3-12b and
        deepseek-v2-236b (their fp32 states exceed the card) and
        ``launch.serve --real`` on all three (no paged path), each
        exiting non-zero with its message.
    Each part's result goes to standard error as it comes."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import transformer as T
    gcfg = gcfg or cut_depth(get_config(GEMMA_ARCH),
                             FAMILIES_DEPTH[GEMMA_ARCH])
    dcfg = dcfg or get_config(DEEPSEEK_ARCH)
    wcfg = wcfg or cut_depth(get_config(WHISPER_ARCH),
                             FAMILIES_DEPTH[WHISPER_ARCH])
    R, _ = T._gemma3_shape(gcfg)
    whisper = whisper or dict(batch=(8, 128), steps=8,
                              decode=(8, 64, 32, 128), cpu_check=(2, 64),
                              lr=WHISPER_LR)
    parts = {
        "gemma3": lambda: gemma3_serve(device, gcfg, *gemma),
        "gemma3_train": lambda: train_steps(
            device, cut_depth(gcfg, R + 1), gemma_train),
        "gemma3_vs_cpu": lambda: device_vs_cpu(
            get_smoke_config(GEMMA_ARCH), device, check, TRAIN_GRAD_RTOL),
        "deepseek": lambda: deepseek_serve(device, dcfg, *deepseek),
        "deepseek_vs_cpu": lambda: device_vs_cpu(
            get_smoke_config(DEEPSEEK_ARCH), device, check,
            TRAIN_GRAD_RTOL),
        "whisper": lambda: train_phase(device, cfg=wcfg, **whisper),
        "refusals": lambda: _refusals({
            f"{kind}:{arch}": case
            for arch in (GEMMA_ARCH, DEEPSEEK_ARCH, WHISPER_ARCH)
            for kind, case in _refusal_cases(device, arch).items()
            if kind == "serve" or arch != WHISPER_ARCH})}
    out, part_s = {}, {}
    for name, run in parts.items():
        t0 = time.perf_counter()
        out[name] = run()
        part_s[name] = time.perf_counter() - t0
        print(json.dumps({"families_part": name, "part_s": part_s[name],
                          **out[name]}), file=sys.stderr, flush=True)
    return {**out, "part_s": part_s}


# ---------------------------------------------------------------------------
# phase 5k: tensor-parallel serving, the mesh's shards on one card
# ---------------------------------------------------------------------------

# the mesh oracle step: the sharded step against the one-device step on
# the same state (a MoE's routing pinned to the sharded step's choices).
# Paged attention gives each head the same bytes in both (the one-device
# split-KV plan); the q/k/v products over column slices may round apart
# by an ulp, which 28 (16) layers of bf16 activations carry to the fp32
# logits as the moe phase's kernel-against-plain attention does: held
# per logit to the moe phase's bound, the argmax equal or a near-tie.
MESH_LOGIT_ATOL = MOE_LOGIT_ATOL


def mesh_transfers(pools, n_shards: int) -> dict:
    """The per-shard swap plane's accounting: one d2h per staged
    swap-out and one h2d per swap-in sub-slab, for every shard; raises
    otherwise."""
    got = {"n_shards": pools.n_shards,
           "staged_out_calls": pools.staged_out_calls,
           "staged_in_calls": pools.staged_in_calls,
           "d2h_transfers": pools.d2h_transfers,
           "h2d_transfers": pools.h2d_transfers}
    if (pools.n_shards != n_shards
            or pools.d2h_transfers != n_shards * pools.staged_out_calls
            or pools.h2d_transfers != n_shards * pools.staged_in_calls):
        raise AssertionError(f"transfers are not one per staged chunk per "
                             f"shard over {n_shards} shards: {got}")
    return got


def shard_attention(case, n_shards: int) -> dict:
    """The case's paged attention cut into ``n_shards`` head shards: each
    shard's kernel on its local heads with the one-device split-KV plan,
    held per element to its plain version (phase 3's bound); the shards'
    outputs concatenated in order against the one-device launch (the same
    bound; byte equality reported)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    q, k, v = case["q"], case["k"], case["v"]
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    hq, hk = Hq // n_shards, Hkv // n_shards
    rest = (case["bt"], case["ctx"], case["scale"], case["ppcb"])
    outs, errs = [], []
    for s in range(n_shards):
        args = (q[:, s * hq:(s + 1) * hq].contiguous(),
                k[:, :, s * hk:(s + 1) * hk].contiguous(),
                v[:, :, s * hk:(s + 1) * hk].contiguous()) + rest
        out = pa.paged_attention(*args, plan_kv_heads=Hkv)
        errs.append(attention_error(out, pa.paged_attention_plain(*args),
                                    f"paged_attention shard {s}"))
        outs.append(out)
    whole = pa.paged_attention(q, k, v, *rest)
    cat = torch.cat(outs, dim=1)
    _sync(q.device)
    return {"shards": n_shards, "q_kv_heads_per_shard": [hq, hk],
            "max_abs_err_by_shard": errs,
            "concat_vs_one_device_err": attention_error(
                cat, whole, "paged_attention shards concatenated"),
            "concat_byte_equal_one_device": _bytes_equal(cat, whole),
            "tolerance": {"atol": ATTN_ATOL, "rtol": ATTN_RTOL}}


def cross_mesh_swap(device, L: int, Hkv: int, D: int, n_shards: int,
                    seed: int = 5) -> dict:
    """Phase 3c's 64-block staged swap out of a one-device pool and out of
    an (1, ``n_shards``) pool holding the same bytes: the host blocks
    byte-equal; then back into each, its blocks zeroed first: the device
    pools byte-equal to before.  Host ms of each leg, and the transfers
    (1 and ``n_shards`` a leg)."""
    import numpy as np
    import torch
    from repro_torch.cache.paged import PagedPools
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.sharding import POOL_HEAD_AXIS, shard_tensor
    one, runs, blocks, cpu_ids = swap_pools(device, seed, L, Hkv, D)
    before = one.gpu.clone()
    sharded = PagedPools(one.spec, device=device, mesh=make_serving_mesh(
        (1, n_shards), [device] * n_shards))
    for g, part in zip(sharded.gpu, shard_tensor(before, POOL_HEAD_AXIS,
                                                 n_shards)):
        g.copy_(part)
    idx = torch.as_tensor(blocks, device=device)
    out = {}
    for name, p in (("one_device", one), (f"mesh_1x{n_shards}", sharded)):
        _sync(device)
        t0 = time.perf_counter()
        p.copy_out_staged(runs, cpu_ids)
        out_ms = (time.perf_counter() - t0) * 1e3
        for g, _ in p._shards():
            g[:, :, idx] = 0
        _sync(device)
        t0 = time.perf_counter()
        p.copy_in_staged(cpu_ids, runs)
        _sync(device)
        out[name] = {"out_ms": out_ms,
                     "in_ms": (time.perf_counter() - t0) * 1e3,
                     "d2h_transfers": p.d2h_transfers,
                     "h2d_transfers": p.h2d_transfers}
    if not np.array_equal(one.cpu, sharded.cpu):
        raise AssertionError("the staged swap-out's host blocks differ "
                             "between the one-device pool and the mesh's")
    if not (_bytes_equal(one.gpu, before)
            and _bytes_equal(sharded.gpu_full(), before)):
        raise AssertionError("a pool's blocks after the staged swap-in "
                             "differ from before")
    if out[f"mesh_1x{n_shards}"]["d2h_transfers"] != n_shards:
        raise AssertionError(f"the mesh's swap-out made "
                             f"{out[f'mesh_1x{n_shards}']['d2h_transfers']} "
                             f"transfers over {n_shards} shards")
    return {"blocks": len(blocks), "bytes": len(blocks)
            * one.spec.block_bytes(), "legs": out,
            "host_byte_equal": True, "device_byte_equal": True}


def mesh_oracle(eng, snap, params, tol: float = NEAR_TIE) -> dict:
    """One decode step at the engine's bucket from the snapshot's state
    (a replay of the mesh engine ``eng``): the sharded step over the
    per-shard pools, and the one-device step (``params``, the full
    serving tree) over the shards' pools concatenated, the one-device
    step's MoE routing pinned to the sharded step's choices.  Per active
    row the logits (the sharded step's as the shards' vocab slices
    concatenated) within MESH_LOGIT_ATOL, and the argmax equal or a
    near-tie of the one-device step's logits.  Raises with every row's
    record where a row fails."""
    import torch
    from repro_torch.core import decode_runner as dr
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models import paged
    from repro_torch.models.sharding import POOL_HEAD_AXIS, unshard
    cfg = eng.runner.mb["cfg"]
    shards = eng.runner._params
    t = dict(zip(dr.STEP_TENSORS, snap["clones"]))
    n = len(t["pool"])
    real_route = moe.route
    active = t["active"].cpu()

    def step(p, pool, pinned=None):
        plans = []

        def route(router, xf, m):
            plan = real_route(router, xf, m)
            if pinned is not None:
                plan = moe.plan_for(plan.probs, pinned[len(plans)], m)
            plans.append(plan.eids)
            return plan
        moe.route = route
        try:
            with torch.no_grad():
                x, _ = paged._decode_hidden(
                    p, pool, t["block_tables"], t["context_lens"].clone(),
                    t["tokens"], cfg)
                rep = p[0] if isinstance(p, list) else p
                head = rep["embed"] if cfg.tie_embeddings else rep["lm_head"]
                if isinstance(p, list) and cfg.vocab_size % n == 0:
                    lg = unshard(paged.vocab_slices(head["table"], x, n), 1)
                else:
                    lg = L.unembed(head, x)
                return lg.cpu(), plans
        finally:
            moe.route = real_route

    ls, plans = step(shards, [q.clone() for q in t["pool"]])
    l1, _ = step(params, unshard(t["pool"], POOL_HEAD_AXIS),
                 pinned=plans if cfg.moe is not None else None)
    records, faults = [], []
    for r in torch.nonzero(active)[:, 0].tolist():
        a, b = int(ls[r].argmax()), int(l1[r].argmax())
        rec = {"row": r, "ctx": int(t["context_lens"][r]),
               "logit_err": float((ls[r] - l1[r]).abs().max()),
               "argmax_gap": float(l1[r, b] - l1[r, a])}
        if not rec["logit_err"] <= MESH_LOGIT_ATOL:
            faults.append(f"row {r}: logits {rec['logit_err']} from the "
                          f"one-device step's (> {MESH_LOGIT_ATOL})")
        if a != b and rec["argmax_gap"] >= tol:
            faults.append(f"row {r}: the sharded step's argmax {a} is "
                          f"{rec['argmax_gap']} below the one-device "
                          "step's")
        records.append(rec)
    if faults:
        raise AssertionError(f"{faults}; rows: {json.dumps(records)}")
    return {"rows": records,
            "max_abs_logit_err": max(r["logit_err"] for r in records),
            "logits_equal": bool(torch.equal(ls[active], l1[active])),
            "argmax_near_ties": sum(r["argmax_gap"] > 0 for r in records),
            "tolerance": {"logit_atol": MESH_LOGIT_ATOL, "near_tie": tol}}


def mesh_prefill(eng, params, sizes=(256, 352)) -> dict:
    """For each prompt size of ``sizes`` (the engine workload's shortest
    and longest first turns: chunks padded to 256 and 512 tokens), one
    prefill chunk through the mesh engine's sharded chunk forward and
    through the one-device one (``params``, the full serving tree), from
    empty carries: the last logits' largest difference and argmaxes, and
    whether the carries (the shards' concatenated) and layer 0's K (which
    the q/k/v products over column slices alone feed) are byte-equal.
    Held byte-equal (logits and carries): the shards' attention runs as
    one product over all their heads, the one-device product."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.sharding import CARRY_HEAD_AXIS, unshard
    cfg = eng.runner.mb["cfg"]
    out = {}
    for n_tokens in sizes:
        toks = [(7 * i + 3) % cfg.vocab_size for i in range(n_tokens)]
        one = ops.prefill_chunk(params, toks, None, None, 0, cfg=cfg,
                                block_size=16)
        sh = ops.prefill_chunk(eng.runner._params, toks, None, None, 0,
                               cfg=cfg, block_size=16, mesh=eng.mesh)
        k, v = (unshard(c, CARRY_HEAD_AXIS) for c in sh[1:3])
        out[n_tokens] = {
            "logit_max_abs_diff": float((sh[0] - one[0]).abs().max()),
            "argmax": [int(sh[0].argmax()), int(one[0].argmax())],
            "k_byte_equal": _bytes_equal(k, one[1]),
            "v_byte_equal": _bytes_equal(v, one[2]),
            "layer0_k_byte_equal": _bytes_equal(k[0], one[1][0]),
            "k_max_abs_diff": float((k.float() - one[1].float())
                                    .abs().max())}
        r = out[n_tokens]
        if not (r["k_byte_equal"] and r["v_byte_equal"]
                and torch.equal(sh[0], one[0])):
            raise AssertionError(f"the sharded prefill chunk of {n_tokens} "
                                 f"tokens parts from the one-device one: {r}")
    return out


def mesh_sampling(bundle, n_shards: int) -> dict:
    """The sampling phase's batch (odd requests sampled) served on (1,
    ``n_shards``): the first replay of each variant held to its eager
    step, sampled tokens the plain sampler's draws from the dense
    forward (or a stated near-tie), greedy ones the dense argmax or a
    near-tie."""
    shape = (1, n_shards)
    with replays_held_to_eager() as held:
        eng, convs = run_sampling(bundle, mesh=shape)
    stats = check_sampling(eng, convs)
    if not any(c["sampled"] for c in held):
        raise AssertionError("no sampled decode-step variant was replayed "
                             "on the mesh")
    greedy = [check_tokens(eng, bundle, c) for c in convs[::2]]
    sampled = [check_sampled_tokens(eng, bundle, c, SAMPLING)
               for c in convs[1::2]]
    mesh_transfers(eng.pools, n_shards)
    return {**stats, "replays_checked": held,
            "greedy_equal": sum(r["equal"] for r in greedy),
            "greedy_near_ties": sum(r["near_ties"] for r in greedy),
            "sampled_generated": sum(r["generated"] for r in sampled),
            "sampled_equal": sum(r["equal"] for r in sampled),
            "sampled_near_ties": [w for r in sampled
                                  for w in r["near_ties"]]}


def mesh_serve(device, arch: str, n_shards: int, cfg=None,
               serving: bool = False, sampling: bool = False) -> dict:
    """``arch`` (``cfg``: another config, for a rehearsal on the CPU)
    served by the engine phase's workload on one device and on a (1,
    ``n_shards``) mesh whose shards all name ``device``: the mesh's
    warm-up (which pays the process's one-time costs; each bucket's
    first replay held to its eager step, the fullest replay of each
    bucket kept), the one-device run, then the mesh's timed run, the
    serving kernels' counts set to 0 just before; all held to the
    simulated clock.  Checks
    (``check_engine`` on every run): every turn finished, no copy retried
    or failed, every conversation swapped both ways, the held swap
    counts (``ENGINE_SWAPS`` / ``MOE_SWAPS``) on every mesh; one
    transfer per staged chunk per shard (``mesh_transfers``); on the
    card, paged attention once per layer per shard per step, each shard's
    run copies once per staged chunk; the graph counts of the one-device
    run; the warm-up's and the timed run's tokens equal; each
    conversation's tokens equal to the one-device run's, or (dense) every
    token the dense argmax or a near-tie (``check_tokens``), or (MoE)
    reported with its first difference, the MoE's tokens being held by
    ``mesh_oracle`` as the moe phase holds them by its oracle; the oracle
    step; the prefill chunk against the one-device one, reported
    (``mesh_prefill``); the engine bucket's attention per shard
    (``shard_attention``);
    one staged swap across the meshes (``cross_mesh_swap``); with
    ``sampling``, ``mesh_sampling``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches as kl
    from repro_torch.launch.serve import _serving_kernels
    from repro_torch.models import transformer as T
    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = cfg or get_config(arch)
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=device, serving=serving)
    init_s = time.perf_counter() - t0
    mem = ({"after_init_gb": torch.cuda.memory_allocated() / 1e9,
            "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
           if cuda else {})
    bundle = {"cfg": cfg, "params": params}
    mesh_bundle = {**bundle, "mesh_devices": [device] * n_shards}
    shape = (1, n_shards)
    convs = conversations(8, (256, 288, 320, 352), (96, 128, 160),
                          max_tokens=32)
    sizes = dict(gpu_blocks=160, cpu_blocks=1024, max_running=8)
    expect = {ARCH: ENGINE_SWAPS, MOE_ARCH: MOE_SWAPS}.get(cfg.name)
    with swaps_follow_the_clock(), replays_held_to_eager() as held, \
            fullest_replays() as snaps:
        warm, warm_wall, _, warm_swaps = run_engine(mesh_bundle, convs,
                                                    mesh=shape, **sizes)
    check_engine(warm, convs, warm_swaps, expect_swaps=expect)
    mesh_transfers(warm.pools, n_shards)
    if not held:
        raise AssertionError("no captured decode step was replayed on the "
                             "mesh")
    with swaps_follow_the_clock():
        one, one_wall, one_host, one_swaps = run_engine(bundle, convs,
                                                        **sizes)
    one_stats = check_engine(one, convs, one_swaps, expect_swaps=expect)
    kernels = _serving_kernels()
    kl.reset(*kernels.values())
    with swaps_follow_the_clock() as hold:
        eng, wall, host, swaps = run_engine(mesh_bundle, convs, mesh=shape,
                                            **sizes)
    launched = {k: fn.launches for k, fn in kernels.items()}
    per_shard = {k: [kl.on(fn, p) for p in eng.pools.gpu]
                 for k, fn in kernels.items()}
    stats = check_engine(eng, convs, swaps, expect_swaps=expect)
    transfers = mesh_transfers(eng.pools, n_shards)
    steps = stats["decode_steps"]
    want = {"paged_attention": cfg.n_layers * steps,
            "block_gather_runs": stats["swap_out_calls"],
            "block_scatter_runs": stats["swap_in_calls"]}
    if cuda:
        for k, counts in per_shard.items():
            if counts != [want[k]] * n_shards or launched[k] != sum(counts):
                raise AssertionError(
                    f"{k}: launched {launched[k]}, per shard {counts}; "
                    f"expected {want[k]} on each of {n_shards} shards")
    graphs = ("graphs_captured", "eager_steps", "graph_replays",
              "decode_steps", "prefill_chunks")
    graphs_apart = {g: (stats[g], one_stats[g]) for g in graphs
                    if stats[g] != one_stats[g]}
    if graphs_apart:
        raise AssertionError(f"the mesh's decode graphs differ from the "
                             f"one-device run's (mesh, one device): "
                             f"{graphs_apart}")
    if eng._token_hist_by_conv != warm._token_hist_by_conv:
        raise AssertionError("the mesh's warm-up and timed runs gave other "
                             "tokens")
    differ = [c for c in convs if eng._token_hist_by_conv[c.conv_id]
              != one._token_hist_by_conv[c.conv_id]]
    tokens = {"conversations": len(convs),
              "equal_one_device": len(convs) - len(differ)}
    if cfg.moe is None:
        checked = [check_tokens(eng, bundle, c) for c in differ]
        tokens.update(
            checked_dense=len(checked),
            dense_equal=sum(r["equal"] for r in checked),
            dense_near_ties=sum(r["near_ties"] for r in checked),
            max_gap=max([r["max_gap"] for r in checked], default=0.0),
            tolerance=NEAR_TIE)
    else:
        tokens["first_differences"] = [
            [c.conv_id, *first_divergence(
                bundle, eng._token_hist_by_conv[c.conv_id],
                one._token_hist_by_conv[c.conv_id])] for c in differ]
    bucket = (eng.runner.batch_bucket, eng.runner._pages_bucket)
    snap = snaps.get(bucket) or max(snaps.values(), key=lambda s: s["active"])
    oracle = mesh_oracle(eng, snap, T.serving_params(params))
    prefill = mesh_prefill(eng, T.serving_params(params))
    del one, warm, snaps, snap
    out = {"arch": cfg.name, "mesh_shape": list(shape),
           "devices": [str(device)] * n_shards, "init_s": init_s,
           "wall_s": wall, "warm_wall_s": warm_wall,
           "one_device_wall_s": one_wall,
           "tokens_per_s": stats["tokens"] / wall,
           "host_s_by_method": host, "one_device_host_s_by_method": one_host,
           "clock_hold_wait_s": hold["wait_s"], "launches": launched,
           "launches_per_shard": per_shard, "transfers": transfers,
           "replays_checked": held, "tokens_vs_one_device": tokens,
           "oracle": oracle, "prefill_vs_one_device": prefill, **stats}
    del eng
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    case = attention_case(8, 64, device, seed=1, ctx_range=(256, 600),
                          Hq=cfg.n_heads, Hkv=cfg.n_kv_heads,
                          D=cfg.resolved_head_dim)
    out["attention_per_shard"] = shard_attention(case, n_shards)
    del case
    out["swap_across_meshes"] = cross_mesh_swap(
        device, cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim,
        n_shards)
    if sampling:
        out["sampling"] = mesh_sampling(mesh_bundle, n_shards)
    if cuda:
        mem["phase_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["memory"] = mem
    del bundle, mesh_bundle, params
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_refusals(device) -> dict:
    """The engine's refusals, before any work (the device's allocated
    bytes unchanged): a mesh whose shards name two CUDA devices
    (``NotImplementedError``), and a default device list shorter than the
    mesh (the reference's ``ValueError``)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import EngineConfig, ServingEngine
    from repro_torch.models import transformer as T
    cfg = get_smoke_config(ARCH)
    bundle = {"cfg": cfg, "params": T.init_params(cfg, seed=SEED,
                                                  device=device)}
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    cases = {"two_cuda_devices": ((1, 2), ["cuda:0", "cuda:1"],
                                  NotImplementedError),
             "default_devices_too_few": ((1, max(n, 1) + 1), None,
                                         ValueError)}
    out = {}
    for name, (shape, devices, exc) in cases.items():
        allocated = (torch.cuda.memory_allocated()
                     if torch.cuda.is_available() else 0)
        cfg_e = EngineConfig(mode="real", num_gpu_blocks=16,
                             num_cpu_blocks=16, mesh_shape=shape)
        try:
            ServingEngine(cfg_e, model_bundle={**bundle,
                                               "mesh_devices": devices})
        except exc as e:
            out[name] = str(e)
        else:
            raise AssertionError(f"mesh_shape {shape} on {devices}: not "
                                 "refused")
        if torch.cuda.is_available() and \
                torch.cuda.memory_allocated() != allocated:
            raise AssertionError(f"{name}: the refused engine allocated "
                                 "device memory")
    return out


def mesh_phase(device, qcfg=None, ocfg=None) -> dict:
    """Tensor-parallel serving with every shard on ``device``, at full
    width where the configs are not given (a rehearsal on the CPU passes
    reduced ones): qwen2-1.5b whole on (1, 2), 6 / 1 heads a shard, with
    the sampled batch; olmoe-1b-7b whole from its bf16 serving init on (1,
    4), 4 / 4 heads a shard (``mesh_serve`` each); then the refusals
    (``mesh_refusals``).  Each part's result goes to standard error as it
    comes."""
    parts = {
        "qwen2": lambda: mesh_serve(device, ARCH, 2, qcfg, sampling=True),
        "olmoe": lambda: mesh_serve(device, MOE_ARCH, 4, ocfg,
                                    serving=True),
        "refusals": lambda: mesh_refusals(device)}
    out = {}
    for name, run in parts.items():
        out[name] = run()
        print(json.dumps({"mesh_part": name, **out[name]}, default=str),
              file=sys.stderr, flush=True)
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 5l: the examples (llama3.2-3b served at full width, train_lm)
# ---------------------------------------------------------------------------

EXAMPLES = ROOT / "examples"
QUICKSTART_SERVED = re.compile(r"^served (\d+) tokens over (\d+) iters$")
QUICKSTART_SWAPS = re.compile(r"^preemptions (\d+)  swap ops (\d+)  ")
TRAIN_LM_DONE = re.compile(r"^loss ([\d.]+) -> ([\d.]+); checkpoint "
                           r"round-trip OK ")


def run_example(script: str, args=(), timeout: float = 600.0,
                folder: Path = EXAMPLES) -> dict:
    """``python FOLDER/SCRIPT ARGS`` (``examples/`` by default) from the
    checkout's root; raises on a non-zero exit.  Returns {"wall_s",
    "stdout": its lines}."""
    import os
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(folder / script), *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{script} {' '.join(args)} exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    return {"wall_s": wall, "stdout": proc.stdout.splitlines()}


def _matched(pattern, lines, what: str):
    m = next((pattern.match(ln) for ln in lines if pattern.match(ln)), None)
    if m is None:
        raise AssertionError(f"{what}: no line matching {pattern.pattern} "
                             f"in {lines[-10:]}")
    return m


def examples_phase(device, params=None, train_steps: int = 50) -> dict:
    """The examples: ``examples/torch_quickstart.py``'s engine built in
    process (``build(device)``: llama3.2-3b at full width on ``cuda``, its
    reduced config on ``cpu``; ``params`` overrides the seed-0 weights)
    and run — every turn finished, preemption, swaps both ways, no copy
    retried or failed, greedy tokens the dense argmax or near-ties, each
    serving kernel launched (counted at every replay), wall and host
    seconds by method — then the quickstart and ``torch_train_lm.py
    --steps train_steps`` as subprocesses: exit 0, their summary lines
    read (the loss falls, the checkpoint round-trips)."""
    import tempfile

    import torch
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    import torch_quickstart as qs
    from repro_torch.kernels import launches
    from repro_torch.kernels import block_copy as bc
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device(device)
    flag = [] if dev.type == "cuda" else ["--device", "cpu"]
    kernels = {"paged_attention": pa.paged_attention,
               "block_gather_runs": bc.block_gather_runs,
               "block_scatter_runs": bc.block_scatter_runs}
    t0 = time.perf_counter()
    eng = qs.build(dev.type, params=params)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bundle = eng.runner.mb
    convs = qs.conversations()
    host = _time_methods([(eng.runner, "decode"), (eng.runner, "flush"),
                          (eng.runner, "_scatter_rows"),
                          (eng.runner, "prefill_chunk_compute"),
                          (eng.pools, "copy_out_staged"),
                          (eng.pools, "copy_in_staged")])
    swaps = _count_swaps(eng.swap)
    launches.reset(*kernels.values())
    t0 = time.perf_counter()
    metrics = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: w.launches for k, w in kernels.items()}
    checked = check_engine(eng, convs, swaps, every_conv_swapped=False)
    tokens = [check_tokens(eng, bundle, c) for c in convs]
    if dev.type == "cuda" and not all(launched.values()):
        raise AssertionError(f"a serving kernel was not launched: "
                             f"{launched}")
    s, sw = metrics.summary(), eng.swap.stats()
    cfg = bundle["cfg"]
    eng.shutdown()
    del eng, bundle
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "build_s": build_s, "wall_s": wall,
           "host_s": host, **checked, "launches": launched,
           "iterations": s["iterations"], "swap_ops": sw["total_ops"],
           "swap_blocks": sw["total_blocks"],
           "greedy_equal": sum(r["equal"] for r in tokens),
           "greedy_near_ties": sum(r["near_ties"] for r in tokens),
           "greedy_max_gap": max(r["max_gap"] for r in tokens),
           "tolerance": NEAR_TIE}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run = run_example("torch_quickstart.py", flag)
    served = _matched(QUICKSTART_SERVED, run["stdout"], "torch_quickstart")
    pre = _matched(QUICKSTART_SWAPS, run["stdout"], "torch_quickstart")
    out["quickstart_cli"] = {
        "wall_s": run["wall_s"], "tokens": int(served[1]),
        "iterations": int(served[2]), "preemptions": int(pre[1]),
        "swap_ops": int(pre[2])}
    if out["quickstart_cli"]["tokens"] != out["tokens"]:
        raise AssertionError(f"torch_quickstart served "
                             f"{out['quickstart_cli']['tokens']} tokens, "
                             f"the engine {out['tokens']}")
    with tempfile.TemporaryDirectory() as tmp:
        run = run_example("torch_train_lm.py", [
            *flag, "--steps", str(train_steps),
            "--checkpoint", str(Path(tmp) / "ckpt.npz")])
    done = _matched(TRAIN_LM_DONE, run["stdout"], "torch_train_lm")
    first, last = float(done[1]), float(done[2])
    if not last < first:
        raise AssertionError(f"torch_train_lm: loss {first} -> {last}")
    out["train_lm_cli"] = {"wall_s": run["wall_s"], "steps": train_steps,
                           "loss_first": first, "loss_last": last,
                           "checkpoint_round_trip": True}
    return out


# ---------------------------------------------------------------------------
# phase 5o: the dev scripts (scripts/torch_dev_{engine,kernels,smoke}.py)
# ---------------------------------------------------------------------------

SCRIPTS = ROOT / "scripts"
DEV_KERNEL = re.compile(r"^(paged_attention|block_copy|block_copy_grouped) "
                        r"maxerr (\S+)$")
DEV_ENGINE = re.compile(r"^(\S+) +p99ttft= *([\d.]+)ms .* tok=(\d+) .*"
                        r"short_copy_resumes=(\d+)$")
DEV_SMOKE = re.compile(r"^(OK|FAIL) +(\S+?):? ")


def dev_phase(device, conversations: int = 20, archs=()) -> dict:
    """The dev scripts as three subprocesses at once on ``device`` (no
    flag on ``cuda``, ``--device cpu`` on the CPU): ``torch_dev_kernels.py``
    (each kernel within its bound of its plain version: the copies
    byte-equal, paged attention as the script holds it),
    ``torch_dev_engine.py CONVERSATIONS`` (four policies, every one the
    same tokens) and ``torch_dev_smoke.py ARCHS`` (all ten by default;
    every one OK).  Exit 0 each, their lines read."""
    from concurrent.futures import ThreadPoolExecutor
    flag = [] if str(device) == "cuda" else ["--device", "cpu"]
    out = {}
    # the three processes run at once: each waits mostly on its start-up
    # and on the card, not on this host
    with ThreadPoolExecutor(3) as pool:
        futures = [pool.submit(run_example, script, args, folder=SCRIPTS)
                   for script, args in (
                       ("torch_dev_kernels.py", flag),
                       ("torch_dev_engine.py", [str(conversations), *flag]),
                       ("torch_dev_smoke.py", [*archs, *flag]))]
        kernels_run, engine_run, smoke_run = [f.result() for f in futures]
    run = kernels_run
    errs = {m[1]: float(m[2]) for m in map(DEV_KERNEL.match, run["stdout"])
            if m}
    if set(errs) != {"paged_attention", "block_copy", "block_copy_grouped"} \
            or errs["block_copy"] != 0 or errs["block_copy_grouped"] != 0:
        raise AssertionError(f"torch_dev_kernels: {run['stdout']}")
    launched = next((ln for ln in run["stdout"]
                     if ln.startswith("launches ")), None)
    out["kernels"] = {"wall_s": run["wall_s"], "max_abs_err": errs,
                      "launches": json.loads(launched[9:]) if launched
                      else None}
    run = engine_run
    rows = {m[1]: {"a10_modelled_p99_ttft_ms": float(m[2]),
                   "tokens": int(m[3]), "short_copy_resumes": int(m[4])}
            for m in map(DEV_ENGINE.match, run["stdout"]) if m}
    if list(rows) != ["vllm", "+dbg", "+dbg+reuse", "fastswitch"] or \
            len({r["tokens"] for r in rows.values()}) != 1:
        raise AssertionError(f"torch_dev_engine: {run['stdout']}")
    out["engine"] = {"wall_s": run["wall_s"],
                     "conversations": conversations, "policies": rows}
    run = smoke_run
    done = {m[2]: m[1] for m in map(DEV_SMOKE.match, run["stdout"]) if m}
    if len(done) != (len(archs) or 10) or set(done.values()) != {"OK"}:
        raise AssertionError(f"torch_dev_smoke: {run['stdout']}")
    out["smoke"] = {"wall_s": run["wall_s"], "archs": sorted(done)}
    return out


# ---------------------------------------------------------------------------
# phase 7: the dry-run and roofline tools
# ---------------------------------------------------------------------------

# the dry-run's mesh cases on the production meshes, CPU-only: started in
# the background at the beginning of the run (``start_dryrun_all``) and
# read in phase 7; its worker processes run at a lower priority than
# this process
DRYRUN_JOBS = 4
# the one shape the reference skips a case for (``specs.supports_case``)
DRYRUN_SKIP_RULE = "long_500k rule"
# the (1, 1) cross-check: the train phase's shape and a contiguous-cache
# decode of the same batch against a cache of as many positions
CROSS_BATCH, CROSS_SEQ = 8, 128


def _dryrun_cmd(*args) -> list:
    return [sys.executable, "-m", "repro_torch.launch.dryrun", *args]


def _dryrun_env() -> dict:
    import os
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def watch_exit(proc, t0: float) -> dict:
    """Drain ``proc``'s pipes on a thread of its own, which notes when
    the process ended: the returned dict gets ``stdout``, ``stderr`` and
    ``seconds`` (since ``t0``) then; join its ``thread`` to wait."""
    done = {}

    def drain():
        done["stdout"], done["stderr"] = proc.communicate()
        done["seconds"] = time.perf_counter() - t0
    done["thread"] = threading.Thread(target=drain, daemon=True)
    done["thread"].start()
    return done


def start_dryrun_all(out_dir: Path, multi_pod: str = "off",
                     jobs: int = DRYRUN_JOBS, extra=()):
    """``python -m repro_torch.launch.dryrun --all`` on the production
    meshes, in the background at a lower priority (it needs no device);
    returns (process, output JSON path, start time, ``watch_exit``'s
    record of it)."""
    import os
    out = out_dir / "dryrun_all.json"
    proc = subprocess.Popen(
        _dryrun_cmd("--all", "--multi-pod", multi_pod, "--jobs", str(jobs),
                    "--out", str(out), *extra),
        cwd=ROOT, env=_dryrun_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        preexec_fn=lambda: os.nice(19))
    t0 = time.perf_counter()
    return proc, out, t0, watch_exit(proc, t0)


FAIRNESS_EXAMPLE = "torch_fairness_comparison.py"
FAIRNESS_ROW = re.compile(r"^(\S+) +(\d+) ms +(\d+) ms +(\d+) ms +([\d.]+) "
                          r"+(\d+) +([\d.]+)s$")


def start_fairness_example():
    """``python examples/torch_fairness_comparison.py`` (the paper's
    ladder in sim mode, CPU only) in the background at a lower priority;
    returns (process, ``watch_exit``'s record of it)."""
    import os
    proc = subprocess.Popen(
        [sys.executable, str(EXAMPLES / FAIRNESS_EXAMPLE)], cwd=ROOT,
        env=_dryrun_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, preexec_fn=lambda: os.nice(19))
    return proc, watch_exit(proc, time.perf_counter())


def check_fairness_example(bg) -> dict:
    """Wait for the background example, at most 600 s; it must exit 0
    having printed the header and one well-formed line per policy of
    ``POLICY_ORDER``, in order.  Returns its rows and seconds."""
    from repro_torch.launch.scenarios import POLICY_ORDER
    proc, done = bg
    done["thread"].join(timeout=600.0)
    if done["thread"].is_alive():
        proc.kill()
        raise AssertionError(f"{FAIRNESS_EXAMPLE} ran past 600 s")
    if proc.returncode != 0:
        raise AssertionError(f"{FAIRNESS_EXAMPLE} exited {proc.returncode}: "
                             f"{done['stderr'][-2000:]}")
    rows = [m for m in map(FAIRNESS_ROW.match, done["stdout"].splitlines())
            if m]
    if [m[1] for m in rows] != list(POLICY_ORDER):
        raise AssertionError(f"{FAIRNESS_EXAMPLE}: rows for "
                             f"{[m[1] for m in rows]}, not {POLICY_ORDER}: "
                             f"{done['stdout'][-2000:]}")
    keys = ("p95_ttft_ms", "p99_ttft_ms", "p999_tbt_ms", "throughput_tok_s",
            "swap_ops", "stall_s")
    return {"seconds": done["seconds"],
            "rows": {m[1]: dict(zip(keys, (int(m[2]), int(m[3]), int(m[4]),
                                           float(m[5]), int(m[6]),
                                           float(m[7]))))
                     for m in rows}}


def dryrun_counts(stdout: str) -> dict:
    """The dry-run's printed cases: OK, SKIP and FAIL lines counted, and
    the failed and skipped cases' lines."""
    lines = stdout.splitlines()
    ok = [ln for ln in lines if ln.startswith("OK   ")]
    skip = [ln for ln in lines if ln.startswith("SKIP ")]
    fail = [ln for ln in lines if ln.startswith("FAIL ")]
    return {"ok": len(ok), "skipped": len(skip), "failed": len(fail),
            "failed_cases": fail, "skipped_cases": skip}


def check_dryrun_all(stdout: str, returncode: int) -> dict:
    """Raise where a mesh case failed, the dry-run exited non-zero, or a
    case was skipped for another reason than the reference's long_500k
    rule; returns ``dryrun_counts``."""
    counts = dryrun_counts(stdout)
    if counts["failed"] or returncode != 0:
        raise AssertionError(f"the dry-run exited {returncode} with "
                             f"{counts['failed']} failed case(s): "
                             f"{counts['failed_cases'][:5]}")
    other = [ln for ln in counts["skipped_cases"]
             if DRYRUN_SKIP_RULE not in ln]
    if other:
        raise AssertionError(f"cases skipped by another rule: {other}")
    if not counts["ok"]:
        raise AssertionError("the dry-run ran no case")
    return counts


def check_argument_bytes(dry_bytes: int, tensors) -> int:
    """The bytes of ``tensors`` (the real step's arguments), which must
    equal the dry-run's per-device argument bytes on a (1, 1) mesh."""
    real = sum(t.numel() * t.element_size() for t in tensors)
    if real != dry_bytes:
        raise AssertionError(f"the dry-run counts {dry_bytes} argument "
                             f"bytes, the real step holds {real}")
    return real


def check_floor(roofline: dict, measured_s: float) -> float:
    """The roofline floor, max(t_compute_s, t_memory_s), which must not
    exceed the measured step: a floor above it means a count is wrong."""
    floor = max(roofline["t_compute_s"], roofline["t_memory_s"])
    if floor > measured_s:
        raise AssertionError(f"the roofline floor {floor * 1e3:.3f} ms "
                             f"exceeds the measured step "
                             f"{measured_s * 1e3:.3f} ms")
    return floor


def _timed(fn, device, n: int):
    """Mean seconds of ``n`` calls of ``fn`` after one untimed call."""
    import torch
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def dryrun_cross_check(device, out_dir: Path, arch: str = ARCH,
                       smoke: bool = False, batch: int = CROSS_BATCH,
                       seq: int = CROSS_SEQ, steps: int = 2) -> dict:
    """The dry-run on a (1, 1) host mesh (a subprocess of the CLI) at
    ``arch``'s train step (B ``batch`` x T ``seq``) and its contiguous-
    cache decode step (B ``batch`` against ``seq`` cached positions),
    against the real steps on ``device``: the argument bytes equal the
    bytes of the tensors the real step holds (fp32 params, AdamW state,
    int32 batch; params, caches, token, position), the roofline floor is
    at most the measured step, and the peak allocated beside arguments
    plus the temp estimate."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import adamw_init, tree_leaves
    out = out_dir / "dryrun_1x1.json"
    cmd = _dryrun_cmd("--mesh", "1x1", "--arch", arch, "--shape", "train_4k",
                      "--shape", "decode_32k", "--batch", str(batch),
                      "--seq", str(seq), "--out", str(out),
                      *(["--smoke"] if smoke else []))
    run = subprocess.run(cmd, cwd=ROOT, env=_dryrun_env(),
                         capture_output=True, text=True, timeout=600)
    check_dryrun_all(run.stdout, run.returncode)
    dry = {r["shape"]: r for r in json.loads(out.read_text())}
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           dtype=torch.int32).to(device)
    res = {}
    params = T.init_params(cfg, seed=SEED, device=device)
    opt = adamw_init(params)
    b = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    d = dry["train_4k"]
    real = check_argument_bytes(
        d["memory"]["argument_bytes_per_device"],
        tree_leaves(params) + tree_leaves(opt) + list(b.values()))
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    step_s = _timed(lambda: S.train_step(params, opt, b, cfg=cfg), device,
                    steps)
    res["train"] = _cross_row(d, real, step_s, device)
    del opt, b
    caches = T.init_caches(cfg, batch, seq, device=device)
    token = tokens[:, 0].contiguous()
    pos = torch.tensor(seq // 2, dtype=torch.int32, device=device)
    d = dry["decode_32k"]
    real = check_argument_bytes(
        d["memory"]["argument_bytes_per_device"],
        tree_leaves(params) + tree_leaves(caches) + [token, pos])
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    step_s = _timed(lambda: S.serve_step(params, caches, token, pos,
                                         cfg=cfg), device, 4 * steps)
    res["decode"] = _cross_row(d, real, step_s, device)
    res["shapes"] = {"batch": batch, "seq": seq}
    return res


def _cross_row(d: dict, real_bytes: int, step_s: float, device) -> dict:
    import torch
    rf, mem = d["roofline"], d["memory"]
    floor = check_floor(rf, step_s)
    est = mem["argument_bytes_per_device"] + mem["temp_bytes_per_device"]
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    return {"argument_bytes": real_bytes, "argument_bytes_equal": True,
            "step_ms": step_s * 1e3, "floor_ms": floor * 1e3,
            "floor_by": "compute" if rf["t_compute_s"] >= rf["t_memory_s"]
            else "memory", "floor_share_of_step": floor / step_s,
            "t_compute_ms": rf["t_compute_s"] * 1e3,
            "t_memory_ms": rf["t_memory_s"] * 1e3,
            "flops_source": rf["flops_source"],
            "bytes_source": rf["bytes_source"],
            "arguments_plus_temp_bytes": est,
            "max_memory_allocated": peak,
            "peak_over_estimate": None if peak is None else peak / est,
            "trace_s": d["t_compile_s"]}


def dryrun_serving(timeout: float = 900.0) -> dict:
    """``--serving`` at full width on the card through the CLI (its one
    mesh case, qwen2-1.5b at long_500k, is skipped by the reference's
    rule): the serving case's line, which must say ok with one abort,
    tokens, decode-graph variants and every serving kernel launched
    except the swap copies (this case preempts nothing)."""
    run = subprocess.run(_dryrun_cmd("--serving", "--arch", ARCH, "--shape",
                                     "long_500k"),
                         cwd=ROOT, env=_dryrun_env(), capture_output=True,
                         text=True, timeout=timeout)
    line = next((ln for ln in run.stdout.splitlines()
                 if ln.startswith(f"ok   {ARCH} x serving ")), None)
    if run.returncode != 0 or line is None:
        raise AssertionError(f"--serving exited {run.returncode}: "
                             f"{run.stdout[-2000:]} {run.stderr[-2000:]}")
    r = json.loads(line.split(" x serving ", 1)[1])
    if r["aborted"] != 1 or r["tokens"] <= 0 or \
            r["decode_graph_variants"] < 1 or \
            r["kernel_launches"]["paged_attention"] <= 0:
        raise AssertionError(f"--serving: {r}")
    return r


def dryrun_audit(device: str = "cuda", timeout: float = 900.0) -> dict:
    """``--audit-jit`` on qwen2-1.5b through the CLI (at full width on the
    card; the reduced config with ``device`` cpu): exit 0, its line ok,
    and its five rows each with static degrees and a live count within
    the bound.  Returns {row: {live_variants, static_degrees, bound}}."""
    extra = [] if device == "cuda" else ["--device", device]
    run = subprocess.run(_dryrun_cmd("--audit-jit", "--arch", ARCH, *extra),
                         cwd=ROOT, env=_dryrun_env(), capture_output=True,
                         text=True, timeout=timeout)
    line = next((ln for ln in run.stdout.splitlines()
                 if ln.startswith(f"ok   {ARCH} x jit-audit ")), None)
    if run.returncode != 0 or line is None:
        raise AssertionError(f"--audit-jit exited {run.returncode}: "
                             f"{run.stdout[-2000:]} {run.stderr[-2000:]}")
    rows = json.loads(line.split(" x jit-audit ", 1)[1])["functions"]
    if len(rows) != 5 or any(r["live_variants"] > r["bound"]
                             for r in rows.values()):
        raise AssertionError(f"--audit-jit: {rows}")
    return rows


def dryrun_phase(device, bg, out_dir: Path) -> dict:
    """Phase 7: the background ``--all`` read (``check_dryrun_all``), the
    serving case and the graph-and-bucket audit on the card, the (1, 1)
    cross-check."""
    import torch
    proc, out, t0, done = bg
    waited = time.perf_counter()
    done["thread"].join(timeout=1800)
    if done["thread"].is_alive():
        proc.kill()
        raise AssertionError("the dry-run's --all ran past 1800 s")
    waited = time.perf_counter() - waited
    stdout, seconds = done["stdout"], done["seconds"]
    counts = check_dryrun_all(stdout, proc.returncode)
    results = json.loads(out.read_text())
    ok = [r for r in results if r["status"] == "ok"]
    traces = sorted(((r["t_compile_s"], f"{r['arch']} x {r['shape']} x "
                      f"{r['mesh']}") for r in ok), reverse=True)
    fallbacks = {}
    for r in ok:
        for k, v in {**r["fallbacks"], **r["decomposed"]}.items():
            fallbacks[k] = fallbacks.get(k, 0) + v
    # the two CLI runs at once (counts, no times); the cross-check, which
    # times a step, after them
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        serving, audit = pool.submit(dryrun_serving), pool.submit(dryrun_audit)
        serving, audit = serving.result(), audit.result()
    cross = dryrun_cross_check(device, out_dir)
    return {"all": {**{k: v for k, v in counts.items()
                       if k != "skipped_cases"},
                    "seconds": seconds, "phase_waited_s": waited,
                    "torch": torch.__version__,
                    "jobs": DRYRUN_JOBS, "slowest_traces_s": traces[:5],
                    "fallbacks_and_decompositions": fallbacks,
                    "cases": [{k: r.get(k) for k in (
                        "arch", "shape", "mesh", "status", "t_compile_s")}
                        | ({"argument_gib": r["memory"][
                            "argument_bytes_per_device"] / 2 ** 30,
                            "temp_gib": r["memory"][
                                "temp_bytes_per_device"] / 2 ** 30,
                            "dominant": r["roofline"]["dominant"]}
                           if r["status"] == "ok" else {})
                        for r in results]},
            "serving": serving, "audit_jit": audit,
            "cross_check_1x1": cross}



def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: chip_smoke.py needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2

    # the kernels build (nvcc needs no card) while phase 1 starts CUDA
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build_pool = ThreadPoolExecutor(1)
    building = build_pool.submit(build.build)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, nvidia_smi=smi[0],
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build (started beside phase 1's CUDA start-up)
    from repro_torch.kernels import block_copy as bc
    from repro_torch.kernels import paged_attention as pa
    built = building.result()
    build_pool.shutdown()
    emit("build", seconds=time.perf_counter() - t0,
         sources={k: {"seconds": r.seconds, "ptxas": r.ptxas}
                  for k, r in built.items()})
    # the dry-run's mesh cases need no device: they trace in the
    # background while the card phases run, and phase 7 reads them
    import tempfile
    dryrun_dir = tempfile.TemporaryDirectory()
    dryrun_bg = start_dryrun_all(Path(dryrun_dir.name))
    # the fairness example (sim mode, CPU only) beside it: the port's own
    # entry point, on a machine without jax
    fairness_bg = start_fairness_example()

    # 3. kernels
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    attn = {}
    for B, n_pages in ((8, 64), (8, 128), (32, 128)):
        case = attention_case(B, n_pages, dev, seed=B + n_pages)
        attn[f"B{B}_pages{n_pages}"] = (case, check_attention(case))
    # the engine's decode bucket: batch 8, 64 pages, contexts 256-600
    engine_case = attention_case(8, 64, dev, seed=1, ctx_range=(256, 600))
    attn["B8_pages64_ctx256_600"] = (engine_case,
                                     check_attention(engine_case))
    # the same bucket at olmoe-1b-7b's heads: 16 / 16, a GQA group of 1
    g1_case = attention_case(8, 64, dev, seed=2, ctx_range=(256, 600),
                             Hq=16, Hkv=16)
    attn["B8_pages64_g1"] = (g1_case, check_attention(g1_case))
    # the kernels' domain past the served D 128: the B 32 x 128 pages
    # shape at D 64 in bf16 and in fp32 (the fp32 kernel), at D 256, and
    # at a GQA group of 16 (Hq 32 / Hkv 2: two head tiles) at D 128
    domain_cases = {}
    for n, (k, kw) in enumerate((("D64", dict(D=64)),
                                 ("D64_fp32", dict(D=64,
                                                   dtype=torch.float32)),
                                 ("D256", dict(D=256)),
                                 ("group16", dict(Hq=32, Hkv=2)))):
        case = attention_case(32, 128, dev, seed=3 + n, **kw)
        attn[f"B32_pages128_{k}"] = (case, check_attention(case))
        domain_cases[k] = case
    timed = attn["B32_pages128"][0]
    a_times = time_attention(timed, flush)
    a_bytes, a_flops = attention_work(timed)
    a_engine_times = time_attention(engine_case, flush)
    a_g1_times = time_attention(g1_case, flush)
    a_domain_times = {k: time_attention(c, flush)
                      for k, c in domain_cases.items()}
    a_bounds = {k: bound_ms(*attention_work(attn[k][0]))[0]
                for k in ("B32_pages128", "B8_pages64_ctx256_600",
                          "B8_pages64_g1",
                          *(f"B32_pages128_{k}" for k in domain_cases))}
    copies = copy_case(dev, seed=1)
    slab, dst_runs = check_copies(copies)
    gather_t, scatter_t, c_bytes = time_copies(copies, dst_runs, flush)
    # the same chunk over olmoe-1b-7b's pool: 32 planes of 64 KiB rows
    moe_copies = copy_case(dev, seed=2, L=16, Hkv=16)
    _, moe_dst_runs = check_copies(moe_copies)
    moe_gather_t, moe_scatter_t, moe_c_bytes = time_copies(
        moe_copies, moe_dst_runs, flush)
    del moe_copies
    c2 = copy_2d_case(copies)
    outs = check_block_copies(c2, slab)
    block_t = time_block_copies(c2, flush)
    flash = {}
    for B, T_len in ((1, 2048), (8, 512)):
        qkv = flash_case(B, 12, T_len, 128, dev, seed=B * T_len)
        out, err = check_flash(qkv)
        flash[(B, T_len)] = dict(qkv=qkv, out=out, err=err,
                                 times=time_flash(qkv, flush),
                                 work=flash_work(B, 12, T_len, T_len, 128,
                                                 True))
    gla_in = gla_case(dev, seed=3)
    gla_out, gla_err = check_gla(gla_in)
    gla_t = time_gla(gla_in, flush)
    all_timed = {"paged_attention_B32_pages128": a_times,
                 "paged_attention_B8_pages64": a_engine_times,
                 "paged_attention_B8_pages64_g1": a_g1_times,
                 **{f"paged_attention_B32_pages128_{k}": t
                    for k, t in a_domain_times.items()},
                 "block_gather_runs": gather_t,
                 "block_scatter_runs": scatter_t,
                 "block_gather_runs_olmoe": moe_gather_t,
                 "block_scatter_runs_olmoe": moe_scatter_t,
                 **{k: t for k, (t, _) in block_t.items()},
                 **{f"flash_attention_B{B}_T{T_len}": f["times"]
                    for (B, T_len), f in flash.items()},
                 "gla_scan_scalar": gla_t}
    emit("kernels",
         paged_attention={k: err for k, (_, err) in attn.items()},
         paged_attention_bound_ms=a_bounds,
         attention_tolerance={"atol": ATTN_ATOL, "rtol": ATTN_RTOL,
                              "fp32": ATTN_F32_TOL},
         run_copies="byte-equal with their plain versions, at qwen2-1.5b's "
                    "pool (56 planes of 8 KB rows) and olmoe-1b-7b's (32 "
                    "planes of 64 KiB rows)",
         block_copies="byte-equal with their plain versions and the "
                      "gather's slab",
         block_copy_pairs=c2["si"].numel(),
         block_copy_grouped_runs=c2["g_src"].numel(),
         flash_attention={f"B{B}_T{T_len}": f["err"]
                          for (B, T_len), f in flash.items()},
         gla_scan_scalar={"y": gla_err[0], "S": gla_err[1]},
         gla_tolerance={"y": {"atol": GLA_Y_ATOL, "rtol": ATTN_RTOL},
                        "S": {"atol": GLA_S_ATOL, "rtol": GLA_S_RTOL}},
         timed={k: [t["ms"], t["plain_ms"], t["library_ms"]]
                for k, t in all_timed.items()},
         timed_columns=["kernel_ms", "plain_ms", "library_ms"])

    # 3b. this slice's path: the ops API at the same full widths
    outs.update(flash_attention=flash[(1, 2048)]["out"],
                gla_scan_scalar=gla_out)
    ops_launches = run_ops_path(c2, flash[(1, 2048)]["qkv"], gla_in, outs)
    emit("ops", launches=ops_launches,
         outputs="bit-equal with the checked kernel outputs")

    # 3c. the swap plane: one 64-block swap three ways at both served
    # models' pool layouts, beside the host link's rate
    emit("swap", nvidia_smi=smi[0], **swap_phase(dev))
    del outs, c2, copies, slab, gla_in, gla_out
    for f in flash.values():
        del f["qkv"], f["out"]

    # 4. engine
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(ARCH)
    params = T.init_params(cfg, seed=SEED, device=dev)
    bundle = {"cfg": cfg, "params": params}
    convs = conversations(8, (256, 288, 320, 352), (96, 128, 160),
                          max_tokens=32)
    sizes = dict(gpu_blocks=160, cpu_blocks=1024, max_running=8)
    # a first run pays one-time costs (library handles, allocator growth)
    # and holds every bucket's first replay against the eager step; the
    # main path is the second, identical run.  Both hold swap tasks to the
    # simulated clock, so their schedules, swap counts and tokens repeat
    with swaps_follow_the_clock(), replays_held_to_eager() as held:
        cold, cold_wall, _, cold_swaps = run_engine(bundle, convs, **sizes)
    cold_stats = check_engine(cold, convs, cold_swaps,
                              expect_swaps=ENGINE_SWAPS)
    if not held:
        raise AssertionError("no captured decode step was replayed")
    pa.paged_attention.launches = 0
    bc.block_gather_runs.launches = 0
    bc.block_scatter_runs.launches = 0
    with swaps_follow_the_clock() as hold:
        eng, wall, host, swaps = run_engine(bundle, convs, **sizes)
    launches = {"paged_attention": pa.paged_attention.launches,
                "block_gather_runs": bc.block_gather_runs.launches,
                "block_scatter_runs": bc.block_scatter_runs.launches}
    stats = check_engine(eng, convs, swaps, expect_swaps=ENGINE_SWAPS)
    if eng._token_hist_by_conv != cold._token_hist_by_conv:
        raise AssertionError("the warm-up and the timed engine runs gave "
                             "other tokens")
    del cold
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    if launches["paged_attention"] != cfg.n_layers * stats["decode_steps"]:
        raise AssertionError(f"paged attention counted "
                             f"{launches['paged_attention']} times over "
                             f"{stats['decode_steps']} decode steps of "
                             f"{cfg.n_layers} layers")
    short = eng.reuse.stats()["short_copy_resumes"]
    if short:
        raise AssertionError(f"the engine phase's 1024-block host pool "
                             f"resumed {short} short copies")
    summ = eng.metrics.summary()
    emit("engine", arch=ARCH, device=name, nvidia_smi=smi[0],
         wall_s=wall, cold_wall_s=cold_wall,
         tokens_per_s=stats["tokens"] / wall, host_s_by_method=host,
         earlier_staged_s=EARLIER_STAGED_S[ARCH],
         clock_hold_wait_s=hold["wait_s"],
         tokens_equal_warm_up=True, launches=launches, **stats,
         short_copy_resumes=short,
         a10_modelled_p50_ttft_ms=summ["p50_ttft_ms"],
         a10_modelled_p99_tbt_ms=summ["p99_tbt_ms"],
         a10_modelled_throughput_tok_s=summ["throughput_tok_s"])

    # 5d's online smoke, a subprocess at full width, runs beside the
    # untimed checks of phases 5 and 5a and is read in 5d
    serve_dir = tempfile.TemporaryDirectory()
    online_bg = ThreadPoolExecutor(1)
    online_run = online_bg.submit(serve_online, Path(serve_dir.name))

    # 5. e2e: every conversation, each swapped out and back in above
    per_conv = [check_tokens(eng, bundle, c) for c in convs]
    emit("e2e", generated=sum(r["generated"] for r in per_conv),
         equal=sum(r["equal"] for r in per_conv),
         near_ties=sum(r["near_ties"] for r in per_conv),
         max_gap=max(r["max_gap"] for r in per_conv), tolerance=NEAR_TIE,
         by_conv=per_conv)

    # 5a. the exact-shape oracle: every conversation straight through
    # prefill_kv + write_tokens + paged_decode_step
    emit("oracle", **check_oracle(eng, bundle, convs))
    del eng
    online = online_run.result()
    online_bg.shutdown()

    # 5b. sampling: half the batch sampled; its first run holds each new
    # variant's first replay against the eager step
    with replays_held_to_eager() as held_s:
        s_eng, s_convs = run_sampling(bundle)
    s_stats = check_sampling(s_eng, s_convs)
    if not any(c["sampled"] for c in held_s):
        raise AssertionError("no sampled decode-step variant was replayed")
    # a bucket left after its first (eager) step has no replay to hold
    emit("graphs", buckets_checked=held + held_s,
         graphs_captured=cold_stats["graphs_captured"],
         buckets_never_replayed=cold_stats["graphs_captured"] - len(held),
         sampled_graphs=s_stats["sampled_graphs"],
         replays_byte_equal_to_eager=True)
    greedy_rows = [check_tokens(s_eng, bundle, c)
                   for c in s_convs if c.conv_id % 2 == 0]
    sampled_rows = [check_sampled_tokens(s_eng, bundle, c, SAMPLING)
                    for c in s_convs if c.conv_id % 2]
    pa.paged_attention.launches = 0
    again, _ = run_sampling(bundle)
    s_launches = pa.paged_attention.launches
    if s_launches != cfg.n_layers * again.runner.stats.steps:
        raise AssertionError(f"paged attention counted {s_launches} times "
                             f"over {again.runner.stats.steps} sampled-batch "
                             f"decode steps of {cfg.n_layers} layers")
    if again._token_hist_by_conv != s_eng._token_hist_by_conv:
        raise AssertionError("a second identical sampling run gave other "
                             "tokens")
    plain, _ = run_sampling(bundle, sampling=None)
    for c in s_convs[::2]:
        if plain._token_hist_by_conv[c.conv_id] != \
                s_eng._token_hist_by_conv[c.conv_id]:
            raise AssertionError(f"greedy request {c.conv_id}: its tokens "
                                 "beside sampled rows differ from those of "
                                 "an all-greedy batch")
    step_times = {**step_ms(s_eng), **step_ms(plain)}
    emit("sampling", **s_stats, sampling=list(SAMPLING),
         paged_attention_launches=s_launches,
         bucket=[s_eng.runner.batch_bucket, s_eng.runner._pages_bucket],
         step_ms=step_times, nvidia_smi=smi[0],
         greedy_equal=sum(r["equal"] for r in greedy_rows),
         greedy_near_ties=sum(r["near_ties"] for r in greedy_rows),
         sampled_generated=sum(r["generated"] for r in sampled_rows),
         sampled_equal=sum(r["equal"] for r in sampled_rows),
         sampled_near_ties=[w for r in sampled_rows
                            for w in r["near_ties"]],
         tolerance={"near_tie": NEAR_TIE, "nucleus_eps": NUCLEUS_EPS},
         second_run_equal=True, greedy_rows_equal_all_greedy_batch=True,
         threefry_words_equal_cpu=threefry_on_card_equals_cpu(dev))
    del s_eng, again, plain

    # 5d. the launcher, at full width, in subprocesses
    emit("serve", nvidia_smi=smi[0],
         **serve_phase(Path(serve_dir.name), online=online))
    serve_dir.cleanup()

    # 5e. the network front-end over two replicas on the card, then the
    # launcher's --serve --router 2 in a subprocess
    with tempfile.TemporaryDirectory() as tmp:
        fe = frontend_phase(bundle, Path(tmp))
    emit("frontend", nvidia_smi=smi[0], **fe,
         launcher=serve_frontend_phase())

    # 5f. the prefix cache, through the launcher, against the cache off
    with tempfile.TemporaryDirectory() as tmp:
        px = prefix_phase(bundle, Path(tmp))
    emit("prefix", nvidia_smi=smi[0], **px)

    # 5m. the control plane's fault, abort and stop paths on the engine
    # phase's bundle and pool: chaos, containment, an abort in each
    # lifecycle state, a stop token
    with tempfile.TemporaryDirectory() as tmp:
        ctl = control_phase(bundle, convs, sizes, Path(tmp))
    emit("control", nvidia_smi=smi[0], **ctl)

    # 5r. the reference's real-mode models: the five paged archs' reduced
    # configs (head_dim 64) on the card, each run held to the same run on
    # the CPU (worker processes), beside the launcher's reduced online
    # smoke
    with tempfile.TemporaryDirectory() as tmp:
        red = reduced_phase(dev, Path(tmp))
    emit("reduced", nvidia_smi=smi[0], **red)

    # 5n. KV reuse under short host pools: the engine phase's workload
    # with 256 and 192 CPU blocks, contaminated copies resumed by
    # restoring their valid prefix and recomputing the rest, in a process
    # of its own (its engines' graphs and pools stay out of this one's
    # memory, which the families phase needs)
    torch.cuda.empty_cache()
    reuse = phase_alone("reuse")
    emit("reuse", **reuse)

    # 5p. the paper's four-policy ladder with mistral-nemo-12b at full
    # width, each policy a fresh engine on one bundle, in a process of its
    # own (``scripts/ladder_probe.py``)
    torch.cuda.empty_cache()
    ladder = phase_alone("ladder")
    emit("ladder", **ladder)

    # 5g. MoE serving: olmoe-1b-7b at full width, then its launcher, in a
    # process of its own
    torch.cuda.empty_cache()
    mo = phase_alone("moe")
    emit("moe", **mo)

    # 5h. training and the contiguous-cache step functions, qwen2-1.5b at
    # full width, in a process of its own
    torch.cuda.empty_cache()
    # (the probe's line names the card and its power limit)
    emit("train", **phase_alone("train"))

    # 5i. the SSM and hybrid families: zamba2-7b served at full width
    # through the SSD scan kernel, rwkv6-1.6b trained, in a process of
    # its own
    torch.cuda.empty_cache()
    ssm = phase_alone("ssm")
    emit("ssm", **ssm)

    # 5j. the last three families: gemma3-12b and deepseek-v2-236b (cut to
    # 2 layers) served through the contiguous-cache steps, whisper-large-v3
    # trained, at full width, in a process of its own
    torch.cuda.empty_cache()
    emit("families", **phase_alone("families"))

    # 5k. tensor-parallel serving: qwen2-1.5b on a (1, 2) mesh and
    # olmoe-1b-7b on a (1, 4) mesh, every shard on this card, in a process
    # of its own
    torch.cuda.empty_cache()
    mesh = phase_alone("mesh")
    emit("mesh", **mesh)

    # 5l. the examples: torch_quickstart's engine with llama3.2-3b at full
    # width, then the quickstart and torch_train_lm as subprocesses, in a
    # process of its own
    torch.cuda.empty_cache()
    ex = phase_alone("examples")
    emit("examples", **ex)

    # 5o. the dev scripts, as subprocesses
    t0 = time.perf_counter()
    dev_run = dev_phase("cuda")
    emit("dev", nvidia_smi=smi[0], seconds=time.perf_counter() - t0,
         **dev_run)

    # 5q. the fairness example, started in the background after phase 2
    emit("fairness_example", **check_fairness_example(fairness_bg))

    # 6. device times of phase 3's calls, after the timed engine runs
    for t in all_timed.values():
        add_device_times(t, flush)
    emit("device_times", nvidia_smi=smi[0],
         timed={k: [t["device_ms"], t["library_device_ms"]]
                for k, t in all_timed.items()},
         timed_columns=["kernel_device_ms", "library_device_ms"],
         events={k: [t["events_ms"], t["library_events_ms"]]
                 for k, t in all_timed.items()},
         device_ms_by={k: [t["device_ms_by"], t["library_device_ms_by"]]
                       for k, t in all_timed.items()},
         profiler_sessions_made_again=remeasured.retries)
    del flush, all_timed

    if "--profile" in sys.argv[1:]:
        emit("profile", **profile_engine(bundle, convs, **sizes))
    del bundle, params

    # 7. the dry-run: its mesh cases (traced in the background since
    # phase 2), --serving on the card, the (1, 1) cross-check
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dr = dryrun_phase(dev, dryrun_bg, Path(dryrun_dir.name))
    dryrun_dir.cleanup()
    emit("dryrun", nvidia_smi=smi[0], seconds=time.perf_counter() - t0,
         **dr)

    # summary
    serving = "serving (ServingEngine, the main path)"
    ops_path = ("repro_torch.kernels.ops at full width; no caller on the "
                "serving path, so no launches there")
    ssm_path = ("zamba2-7b prefill (steps.prefill -> forward_seq -> "
                "mamba2.ssd_scan), one launch per Mamba2 layer")
    zamba = ssm["zamba2"]
    rows = []
    for (kname, src, replaces, path, times, work, err, launched) in (
            ("paged_attention", "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:129", serving,
             a_times, (a_bytes, a_flops),
             max(e for _, e in attn.values()), launches),
            ("block_gather_runs", "block_copy.cu",
             "src/repro/kernels/block_copy.py:140", serving, gather_t,
             (c_bytes, 0), 0.0, launches),
            ("block_scatter_runs", "block_copy.cu",
             "src/repro/kernels/block_copy.py:140", serving, scatter_t,
             (c_bytes, 0), 0.0, launches),
            ("block_copy", "block_copy.cu",
             "src/repro/kernels/block_copy.py:49", ops_path,
             block_t["block_copy"][0], (block_t["block_copy"][1], 0), 0.0,
             ops_launches),
            ("block_copy_grouped", "block_copy.cu",
             "src/repro/kernels/block_copy.py:97", ops_path,
             block_t["block_copy_grouped"][0],
             (block_t["block_copy_grouped"][1], 0), 0.0, ops_launches),
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:82", ops_path,
             flash[(1, 2048)]["times"], flash[(1, 2048)]["work"],
             max(f["err"] for f in flash.values()), ops_launches),
            ("gla_scan_scalar", "gla_scan.cu",
             "src/repro/kernels/gla_scan.py:85", ssm_path, gla_t,
             gla_work(1, 112, 4096, 64, 64, 64),
             max(*gla_err, *zamba["kernel_vs_plain"][
                 "first_layer_scan"].values()),
             {"gla_scan_scalar": zamba["prefill"]["scan_launches"]})):
        b_ms, b_by = bound_ms(*work)
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "launches": launched[kname], "path": path, "max_abs_err": err,
            **({"launches_by_path": {
                "engine": launched[kname],
                "frontend_per_replica": [c[kname] for c in
                                         fe["launches_per_replica"]],
                "prefix_launcher": px["kernel_launches"][kname],
                "control": ctl["launches"][kname],
                "moe_engine": mo["launches"][kname],
                "moe_launcher": mo["launcher"]["kernel_launches"][kname],
                "dryrun_serving": dr["serving"]["kernel_launches"][kname],
                "examples_llama3p2_3b": ex["launches"][kname],
                **{f"reuse_cpu{n}": reuse[str(n)]["launches"][kname]
                   for n in REUSE_CPU_BLOCKS},
                **{f"ladder_{LADDER_ARCH}_{pol}": r["launches"][kname]
                   for pol, r in ladder["policies"].items()},
                **{f"reduced_{arch}_{pol}": r[pol]["launches"][kname]
                   for arch, r in red["archs"].items()
                   for pol in red["policies"]},
                "reduced_launcher_smoke":
                    red["launcher_smoke"]["kernel_launches"][kname],
                **{f"mesh_{part}_1x{len(m['launches_per_shard'][kname])}": {
                    "total": m["launches"][kname],
                    "per_shard": m["launches_per_shard"][kname]}
                   for part, m in (("qwen2", mesh["qwen2"]),
                                   ("olmoe", mesh["olmoe"]))}}}
               if path == serving else {}),
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": times["library_ms"],
            "device_ms": times["device_ms"],
            "device_ms_by": times["device_ms_by"],
            "library_device_ms_by": times["library_device_ms_by"],
            "bound_share": b_ms / times["device_ms"],
            "library_device_ms": times["library_device_ms"]})
    dev_launches = dev_run["kernels"]["launches"]
    rows[0]["launches_by_path"]["dev_kernels"] = \
        dev_launches["paged_attention"]
    for row in rows[3:5]:
        row["launches_by_path"] = {"ops": row["launches"],
                                   "dev_kernels": dev_launches[row["name"]]}
    rows[-1]["library"] = "none: no single PyTorch call computes the scan"
    # the scan: launches on each path; its times at the prefill's shape
    rows[-1]["launches_by_path"] = {
        "zamba2_prefill": zamba["prefill"]["scan_launches"],
        "zamba2_train_step": ssm["zamba2_train"]["scan_launches"],
        "ops": ops_launches["gla_scan_scalar"]}
    rows[-1]["zamba2_prefill_shape"] = zamba["scan_at_prefill_shape"]
    # paged attention at olmoe-1b-7b's group of 1, the engine's bucket
    g1_bound, g1_by = bound_ms(*attention_work(g1_case))
    rows[0]["group1_B8_pages64"] = {
        "max_abs_err": attn["B8_pages64_g1"][1],
        "bound_ms": g1_bound, "bound_by": g1_by,
        **{k: a_g1_times[k] for k in ("ms", "plain_ms", "library_ms",
                                      "device_ms", "library_device_ms",
                                      "device_ms_by",
                                      "library_device_ms_by")}}
    # paged attention across its domain, B 32 x 128 pages
    rows[0]["domain_B32_pages128"] = {}
    for k, c in domain_cases.items():
        d_bound, d_by = bound_ms(*attention_work(c))
        t = a_domain_times[k]
        rows[0]["domain_B32_pages128"][k] = {
            "head_dim": c["q"].shape[-1], "dtype": str(c["q"].dtype),
            "heads": [c["q"].shape[1], c["k"].shape[2]],
            "max_abs_err": attn[f"B32_pages128_{k}"][1],
            "bound_ms": d_bound, "bound_by": d_by,
            "bound_share": d_bound / t["device_ms"],
            **{x: t[x] for x in ("ms", "plain_ms", "library_ms",
                                 "device_ms", "library_device_ms",
                                 "device_ms_by", "library_device_ms_by")}}
    # the run copies at olmoe-1b-7b's pool layout, byte-equal above
    for row, t in ((rows[1], moe_gather_t), (rows[2], moe_scatter_t)):
        m_bound, m_by = bound_ms(moe_c_bytes, 0)
        row["olmoe_layout"] = {
            "max_abs_err": 0.0, "bound_ms": m_bound, "bound_by": m_by,
            "bound_share": m_bound / t["device_ms"],
            **{k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                 "device_ms", "library_device_ms",
                                 "device_ms_by", "library_device_ms_by")}}
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
