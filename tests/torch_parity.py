"""Shared pieces of the port's control-plane suites
(``tests/test_torch_<suite>.py``, each the counterpart of a reference
suite ``tests/test_<suite>.py``): the reduced qwen2-1.5b with the
reference fixture's weights in both packages, and the rules that hold a
real-mode run of the port to the reference's run of the same scenario.

  * sim mode is pure Python on both sides: summaries (all but
    ``callstack_wall_s``), TTFT / TBT lists, ``swap.stats()`` and event
    logs must be equal (``assert_sim_equal``);
  * real mode: the greedy token histories equal, or first different at a
    near-tie of the port's logits (``NEAR_TIE`` of
    ``tests/test_torch_engine.py``; ``assert_histories_agree``).
"""
import functools

import jax
import numpy as np

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jax_T
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as T
from test_torch_engine import NEAR_TIE, first_divergence_gap

ARCH = "qwen2-1.5b"


@functools.lru_cache(maxsize=None)
def smoke_bundles(arch: str = ARCH):
    """(reference bundle, port bundle) of the reduced ``arch``: the
    reference fixture's weights, ``init_params(cfg, PRNGKey(0))``, and
    the same leaves on the CPU for the port (``params_from_numpy``).
    Built once per process; neither bundle may be written."""
    jcfg = jax_smoke_config(arch)
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = T.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    return ({"cfg": jcfg, "params": jparams},
            {"cfg": get_smoke_config(arch), "params": tparams})


def assert_histories_agree(bundle, ours: dict, ref: dict) -> int:
    """Every conversation's greedy history of the port's run (``ours``)
    equals the reference's, or first differs where the port's plain
    forward over the shared prefix has a top-2 logit gap under
    ``NEAR_TIE``.  Returns how many histories are equal."""
    assert set(ours) == set(ref)
    equal = 0
    for cid, want in ref.items():
        d = first_divergence_gap(bundle["params"], bundle["cfg"],
                                 list(ours[cid]), list(want))
        assert d is None or d[1] < NEAR_TIE, \
            f"conv {cid}: histories diverge at {d[0]} with gap {d[1]}"
        equal += d is None
    return equal


def sim_outcome(eng) -> dict:
    """What two sim runs of one scenario must share: the summary less
    ``callstack_wall_s``, the TTFT and TBT lists, the swap manager's
    stats and the event log."""
    summary = eng.metrics.summary()
    summary.pop("callstack_wall_s")
    return {"summary": summary, "ttfts_us": list(eng.metrics.ttfts_us),
            "tbts_us": list(eng.metrics.tbts_us),
            "swap": eng.swap.stats(),
            "events": [e.as_dict() for e in (eng.events or [])]}


def assert_sim_equal(ours, ref) -> None:
    """The port's engine and the reference's ended one sim scenario with
    the same outcome (``sim_outcome``)."""
    got, want = sim_outcome(ours), sim_outcome(ref)
    for key in want:
        assert got[key] == want[key], key


def pin_reference_sim_prefill(monkeypatch) -> None:
    """Give the port's ``ServingEngine`` the reference's sim-mode chunked
    prefill: a sim request preempted mid prefill is swapped out (or, in
    recompute mode, dropped to a resume) whole, keeping its
    ``prefill_remaining``, and ``context_tokens`` holds the whole prompt
    from admission on.  The port aborts such a request instead, as real
    mode does (``ServingEngine._abort_chunked_prefill``), and counts only
    the processed prefix in ``context_tokens``; a scenario that meets the
    difference is held to the reference exactly under this pin, beside a
    case that holds the port's route.  Not pinned: the sim billing of a
    chunked resume of a decoding request (the port's counts the positions
    left to refill, the reference's the whole context)."""
    from repro_torch.core import ReqState, ServingEngine
    port_preempt = ServingEngine._preempt

    def preempt(self, rid):
        req = self._req(rid)
        if self.pools is not None or req.prefill_remaining == 0:
            return port_preempt(self, rid)
        self._swap_out(rid, keep_copy=True)
        if self.config.policy.preemption_mode == "recompute":
            self.sched.move(rid, ReqState.WAITING)
            self._event(rid, "preempt", to="waiting")
        else:
            self.sched.move(rid, ReqState.SWAPPED)
            self._event(rid, "preempt", to="swapped")

    def begin(self, req, new_ctx, reused):
        req.prefill_remaining = new_ctx - reused
        req.context_tokens = new_ctx

    def chunk(self, rid):
        req = self._req(rid)
        n = min(self.config.policy.chunked_prefill_tokens,
                req.prefill_remaining)
        req.prefill_remaining -= n
        if req.prefill_remaining == 0:
            if req.prefill_is_resume:
                req.prefill_is_resume = False
            else:
                self._contained(rid, self._emit_first_token, rid)
        return n

    monkeypatch.setattr(ServingEngine, "_preempt", preempt)
    monkeypatch.setattr(ServingEngine, "_begin_sim_chunked_prefill", begin)
    monkeypatch.setattr(ServingEngine, "_sim_prefill_chunk", chunk)
