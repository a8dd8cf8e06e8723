"""Card tests of the MoE serving path: olmoe-1b-7b at full width (d_model
2048, 16 / 16 heads of 128, 64 experts top-8, d_expert_ff 1024) cut to 2
layers, random weights from a seed.

  * every replay of the runner's captured decode step equals an eager
    step over clones of its state byte for byte, with the router as drawn
    and with a zero router, whose probabilities tie over all experts: every
    row then takes experts 0..7, and at a batch of 8 against 4 slots per
    expert half the pairs are dropped;
  * paged attention at a GQA group of 1 (Hq = Hkv = 16) against its plain
    version;
  * two engine runs under preemption give equal tokens.

Marked ``gpu``; each test skips when ``torch.cuda.is_available()`` is
false (decided in the ``cuda`` fixture, never at import):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_moe.py
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.decode_runner import DecodeRunner
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import moe
from repro_torch.models import transformer as T
from test_torch_gpu_graphs import _held_replays, churn_pools, churn_steps
from test_torch_gpu_kernels import _attention_case, _to

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu

ARCH = "olmoe-1b-7b"
# the kernel's tolerance in tests/test_torch_gpu_kernels.py: one bf16 ulp
# over fp32 sums in another order, with a floor near 0
ATOL, RTOL = 1e-3, 2 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _bundle(device, zero_router: bool = False):
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    params = T.serving_params(T.init_params(cfg, seed=0, device=device))
    if zero_router:
        params["layers"]["ffn"]["router"].zero_()
    return {"cfg": cfg, "params": params}


@pytest.mark.parametrize("zero_router", [False, True],
                         ids=["router", "zero_router"])
def test_moe_graph_replays_equal_the_eager_step_byte_for_byte(
        cuda, zero_router, monkeypatch):
    """The churn run of tests/test_torch_gpu_graphs.py (buckets (1, 1) to
    (8, 8), a row freed and re-registered, blocks swapped in between two
    replays) on the MoE model: every replay equals its eager step."""
    bundle = _bundle(cuda, zero_router)
    cfg = bundle["cfg"]
    seen = {"pairs": 0, "dropped": 0}
    real = moe.route

    def route(router, xf, m):
        plan = real(router, xf, m)
        if torch.cuda.is_current_stream_capturing():
            return plan               # no host read inside a capture
        seen["pairs"] += plan.slot.numel()
        seen["dropped"] += int((plan.slot == plan.capacity).sum())
        if zero_router:
            assert (plan.eids == torch.arange(m.top_k, device=xf.device)
                    ).all()
        return plan
    pools = churn_pools(cfg, cuda)
    runner = DecodeRunner(bundle, block_size=16, trash_block=95)
    held = _held_replays(runner, cfg, monkeypatch)
    monkeypatch.setattr(moe, "route", route)
    for _ in churn_steps(runner, pools, cfg.vocab_size):
        pass
    runner.flush()
    assert len(held) == runner.stats.graph_replays == 43
    assert {b for b, _ in held} == {(1, 1), (1, 2), (2, 4), (4, 4), (8, 8)}
    assert seen["pairs"] > 0
    if zero_router:
        # 8 rows x 8 pairs on experts 0..7, 4 slots each: 4 rows dropped
        # per expert, in every layer of every eager (8, 8) step
        assert seen["dropped"] > 0


@pytest.mark.parametrize("B,n_pages,ctx", [
    (8, 64, "engine"),         # chip_smoke's B8_pages64_g1
    (6, 32, "edges"),          # a ctx-0 row, a freed row, a full table
    (1, 4, "short"),
])
def test_paged_attention_group1_matches_plain(cuda, B, n_pages, ctx):
    rng = np.random.default_rng(B * n_pages)
    bs, H, D = 16, 16, 128
    if ctx == "engine":
        ctxs = np.linspace(256, 600, B).astype(np.int64)
    elif ctx == "edges":
        ctxs = np.asarray([0, 1, 17, 200, n_pages * bs, 1])
    else:
        ctxs = np.asarray([37])
    trash = (B - 1,) if ctx == "edges" else ()
    q, k, v, bt, cl = _attention_case(rng, B, H, H, D, bs, n_pages, ctxs,
                                      trash_rows=trash)
    args = (_to(cuda, q, k, v)
            + _to(cuda, bt, cl, dtype=torch.int32))
    before = pa.paged_attention.launches
    out = pa.paged_attention(*args, D ** -0.5, pages_per_compute_block=4)
    ref = pa.paged_attention_plain(*args, D ** -0.5,
                                   pages_per_compute_block=4)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=RTOL)
    again = pa.paged_attention(*args, D ** -0.5, pages_per_compute_block=4)
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))


def test_two_engine_runs_give_equal_tokens(cuda):
    """Four two-turn conversations on 40 GPU blocks (preemption and
    swaps) served twice, swap tasks held to the simulated clock (which
    requests decode together then does not depend on the threads'
    speed): equal token histories."""
    bundle = _bundle(cuda)
    convs = chip_smoke.conversations(4, (96, 128), (32, 48), max_tokens=16)
    with chip_smoke.swaps_follow_the_clock():
        runs = [chip_smoke.run_engine(bundle, convs, gpu_blocks=40,
                                      cpu_blocks=256, max_running=4)
                for _ in range(2)]
    for eng, _, _, _ in runs:
        assert eng.done() and eng.metrics.preemptions > 0
        assert eng.pools.staged_out_calls > 0
    assert runs[0][0]._token_hist_by_conv == runs[1][0]._token_hist_by_conv
