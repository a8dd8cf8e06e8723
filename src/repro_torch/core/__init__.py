"""FastSwitch core — the paper's primary contribution.

Dynamic Block Group Manager (block_group), Multithreading Swap Manager
(swap_manager), KV Cache Reuse Mechanism (reuse), Priority Scheduler
(scheduler), the open-world serving core (serving: ``ServingEngine``
with the ``add_request/step/abort/continue_session`` API) and the
trace-replay client (engine: ``FastSwitchEngine``) that drives it.
"""
from repro_torch.core.block_group import (  # noqa: F401
    BlockGroup,
    DynamicBlockGroupManager,
    OutOfBlocksError,
)
from repro_torch.core.decode_runner import (  # noqa: F401
    DecodeRequestView,
    DecodeRunner,
)
from repro_torch.core.engine import FastSwitchEngine  # noqa: F401
from repro_torch.core.faults import (  # noqa: F401
    EngineDrainingError,
    EngineOverloadError,
    FaultInjector,
    FaultPlan,
    FatalSwapFault,
    InjectedFault,
    PermanentSwapFault,
    PoisonError,
    TransientSwapFault,
)
from repro_torch.core.invariants import (  # noqa: F401
    InvariantViolation,
    check_engine_invariants,
)
from repro_torch.core.request_api import (  # noqa: F401
    RequestEvent,
    RequestOutput,
    RequestSLOStats,
    SamplingParams,
    SLOSpec,
)
from repro_torch.core.serving import EngineMetrics, ServingEngine  # noqa: F401
from repro_torch.core.policies import (  # noqa: F401
    DBG_ONLY,
    DBG_REUSE,
    FASTSWITCH,
    POLICIES,
    VLLM_BASELINE,
    EngineConfig,
    EnginePolicy,
)
from repro_torch.core.reuse import KVCacheReuseManager  # noqa: F401
from repro_torch.core.scheduler import PriorityScheduler, Request, ReqState  # noqa: F401
from repro_torch.core.swap_manager import MultithreadingSwapManager, SimClock  # noqa: F401
