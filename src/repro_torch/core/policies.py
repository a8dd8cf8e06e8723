"""Engine policy presets: vLLM baseline, incremental opts, full FastSwitch."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

from repro_torch.io.cost_model import A10_PCIE4, HardwareSpec


@dataclass(frozen=True)
class EnginePolicy:
    name: str
    use_block_groups: bool        # Dynamic Block Group Manager (§3.1)
    use_async_swap: bool          # Multithreading Swap Manager (§3.2)
    use_reuse: bool               # KV Cache Reuse Mechanism (§3.3)
    adaptive_async: bool = True
    initial_group_blocks: int = 60
    prealloc_blocks: int = 16
    # BEYOND-PAPER (§Perf): int8-compress KV on the wire — halves every
    # swap transfer's bytes (KV tolerates 8-bit, cf. the kv-int8 decode
    # variant), composing multiplicatively with the paper's three opts.
    swap_wire_bytes_per_elem: int = 2     # 2 = bf16, 1 = int8
    # Preemption mechanism (paper §2.1): "swap" moves KV to host;
    # "recompute" drops it and re-prefills on resumption.
    preemption_mode: str = "swap"
    # Llumnix-style staging buffer (paper §2.2 Challenge #1): per-block
    # copies merged through a small buffer before one transfer — bounded
    # granularity, still dispatch-limited.
    merge_buffer_blocks: int = 1
    # BEYOND-PAPER: Sarathi-style chunked prefill — spread each prefill
    # over iterations (chunk tokens each) so long prompts stop stalling
    # the decode batch (TBT tail).  0 = off (paper-faithful whole-prompt
    # prefill).  In REAL mode the runner executes each chunk as a
    # pow2-bucketed position-masked forward and inserts its KV
    # block-aligned into the pool (DESIGN.md §5) — greedy output stays
    # bit-exact vs the monolithic prefill; sim mode keeps the pure
    # bookkeeping split.
    chunked_prefill_tokens: int = 0


VLLM_BASELINE = EnginePolicy(
    name="vllm", use_block_groups=False, use_async_swap=False,
    use_reuse=False, initial_group_blocks=1, prealloc_blocks=0)

DBG_ONLY = EnginePolicy(
    name="+dbg", use_block_groups=True, use_async_swap=False,
    use_reuse=False)

DBG_REUSE = EnginePolicy(
    name="+dbg+reuse", use_block_groups=True, use_async_swap=False,
    use_reuse=True)

FASTSWITCH = EnginePolicy(
    name="fastswitch", use_block_groups=True, use_async_swap=True,
    use_reuse=True)

FASTSWITCH_ZIP = EnginePolicy(
    name="fastswitch+zip", use_block_groups=True, use_async_swap=True,
    use_reuse=True, swap_wire_bytes_per_elem=1)

VLLM_RECOMPUTE = EnginePolicy(
    name="vllm-recompute", use_block_groups=False, use_async_swap=False,
    use_reuse=False, initial_group_blocks=1, prealloc_blocks=0,
    preemption_mode="recompute")

LLUMNIX = EnginePolicy(
    name="llumnix", use_block_groups=False, use_async_swap=False,
    use_reuse=False, initial_group_blocks=1, prealloc_blocks=0,
    merge_buffer_blocks=2)

FASTSWITCH_CHUNKED = EnginePolicy(
    name="fastswitch+chunked", use_block_groups=True, use_async_swap=True,
    use_reuse=True, chunked_prefill_tokens=512)

POLICIES = {p.name: p for p in (VLLM_BASELINE, DBG_ONLY, DBG_REUSE,
                                FASTSWITCH, FASTSWITCH_ZIP,
                                VLLM_RECOMPUTE, LLUMNIX,
                                FASTSWITCH_CHUNKED)}


@dataclass(frozen=True)
class EngineConfig:
    policy: EnginePolicy = FASTSWITCH
    hardware: HardwareSpec = A10_PCIE4
    num_gpu_blocks: int = 4096
    num_cpu_blocks: int = 16384        # ~60 GB CPU swap space in the paper
    block_size: int = 16
    max_running: int = 48
    max_batch: int = 32                # padded decode batch (real mode)
    mode: str = "sim"                  # "sim" | "real"
    # modelled served-model stats (sim mode; real mode derives from params)
    model_params: int = 8_000_000_000
    kv_bytes_per_token: int = 131072   # LLaMA-8B bf16: 32L*8H*128D*2*2
    seed: int = 0
    # real-mode device-side sampling (DecodeRunner / DESIGN.md §3.6):
    # the ENGINE DEFAULTS a request inherits when its SamplingParams
    # leave a field None.  temperature 0.0 = bit-exact greedy argmax;
    # top_k 0 / top_p 1.0 disable the respective filter.  The values
    # ride a per-row traced (B, 3) array, so neither the defaults nor
    # per-request overrides ever add a compiled decode variant.
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    # Device mesh (data, model) the real-mode engine serves on
    # (DESIGN.md §9): model > 1 shards q/k/v projections, the paged KV
    # pool and the staged swap plane over that many tensor-parallel
    # shards (head-sharded; token streams stay bit-identical to
    # single-device).  (1, 1) — the default — is the single-device
    # engine, byte-for-byte the pre-mesh code path.
    mesh_shape: Tuple[int, int] = (1, 1)
    # Cross-request prefix cache (DESIGN.md §10): radix tree of shared
    # full-block prompt prefixes pinned on the GPU pool, with
    # fairness-aware leaf eviction.  Real mode + reuse-enabled swap
    # policies only; off (the default) leaves every code path untouched.
    prefix_cache: bool = False
    # Swap data plane (DESIGN.md §4): swaps larger than this many blocks
    # are split into chunk tasks the engine interleaves with decode steps
    # (fine-grained conflict syncs then wait only on the overlapping
    # chunk).  0 disables chunking.
    swap_chunk_blocks: int = 64
    # Adaptive swap profiler window: recent-swap records AND recent
    # decode-iteration durations kept for decide_async's cost model.
    r_info_window: int = 64
    # --- robustness / graceful degradation (DESIGN.md §7) -------------
    # Bounded waiting queue: add_request refuses (or sheds) when the
    # waiting queue holds this many requests.  0 = unbounded (legacy).
    max_waiting: int = 0
    # What a full waiting queue does: "reject" raises EngineOverloadError
    # at add_request; "shed" aborts the lowest-value waiting request
    # (SLO-doomed first, then lowest priority, newest first) to make room.
    overload_policy: str = "reject"
    # Run check_engine_invariants every N steps (0 = never).  Cheap
    # enough for CI chaos smokes at N=1; production would sample.
    check_invariants_every: int = 0
    # Swap copy failure handling: bounded retries with linear backoff
    # charged to the task's simulated completion time.
    swap_max_retries: int = 2
    swap_retry_backoff_us: float = 200.0
    # Watchdog: an in-flight swap task still incomplete this long after
    # issue is escalated to a synchronous retried copy.  0 = disabled.
    swap_watchdog_us: float = 0.0
    # Deterministic chaos schedule (core/faults.FaultPlan); None = no
    # injection (all fault hooks are inert no-ops).
    fault_plan: Optional[object] = None

    def with_policy(self, name: str) -> "EngineConfig":
        return replace(self, policy=POLICIES[name])
