"""repro_torch's MoE FFN (``models/moe.py``) against the reference's
``repro.models.moe.moe_forward`` (CPU, op by op on both sides), with the
reference's ``init_moe`` weights converted leaf by leaf.

At E 64, K 8, d 256, f 128 over 8, 40 and 512 tokens, in fp32 and bf16,
with and without a shared expert, at capacity factor 1.25 (pairs past
capacity dropped at 40 and 512 tokens) and 4.0 (none dropped):
  * the routing plan (expert ids, slots, dropped pairs) equals a numpy
    recomputation of the reference's steps from the port's probabilities,
    and ``jax.lax.top_k``'s ids on them;
  * the output and the aux loss agree within the tolerances below;
  * rows of padding (all-equal rows, and zero rows, whose probabilities
    tie) ahead of the real rows route as the reference routes them;
  * two calls are byte-equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import moe as jax_moe
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import moe
from repro_torch.models.transformer import params_from_numpy
from torch_threads import one_torch_thread  # noqa: E402,F401

E, K, D, F = 64, 8, 256, 128

# fp32: the same products summed in other orders (measured at most 2e-6
# on outputs of |y| <= 10).  bf16: an expert product rounds once to bf16
# after fp32 sums in other orders, so a term of the combine may move by
# one bf16 ulp of its own size; the terms here stay below 16, where an
# ulp is 2^-4, and the combine's sum may cancel to far less than its
# terms.  Measured: 0.04 % of the elements differ, by at most 0.03125.
# Few elements may differ at all, and the mean bound catches a
# systematic error such as a wrong gate or a lost expert.
FP32_ATOL = 1e-5
BF16_ATOL = 2 ** -4
BF16_DIFFERING = 1e-3
BF16_MEAN = 1e-4


def assert_bf16_close(got, want):
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    assert float(np.mean(got != want)) < BF16_DIFFERING
    assert float(np.mean(np.abs(got - want))) < BF16_MEAN


def configs(cf: float, shared: int):
    kw = dict(name="moe-test", arch_type="moe", source="test", n_layers=1,
              d_model=D, n_heads=4, n_kv_heads=4, d_ff=F, vocab_size=128)
    mk = dict(n_experts=E, top_k=K, d_expert_ff=F, n_shared_experts=shared,
              capacity_factor=cf)
    return (JaxModelConfig(moe=JaxMoEConfig(**mk), **kw),
            ModelConfig(moe=MoEConfig(**mk), **kw))


_PARAMS = {}


def params(shared: int):
    """(reference, port) parameters of one MoE layer (seeded, cached)."""
    if shared not in _PARAMS:
        jcfg, _ = configs(1.25, shared)
        jp = jax_moe.init_moe(jax.random.PRNGKey(shared), jcfg)
        _PARAMS[shared] = (jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _PARAMS[shared]


def tokens(n: int, n_pad: int = 0, seed: int = 0) -> np.ndarray:
    """(1, n, D) fp32: a shared offset (which skews the routing towards a
    few experts, as real activations do), then ``n_pad`` padding rows
    ahead of the real ones: alternately zero rows and copies of one
    fixed row."""
    rng = np.random.default_rng(seed + n)
    x = (rng.standard_normal((n, D))
         + 0.3 * rng.standard_normal(D)).astype(np.float32)
    for i in range(n_pad):
        x[i] = 0.0 if i % 2 == 0 else x[n - 1]
    return x[None]


def numpy_plan(probs: np.ndarray, m) -> tuple:
    """The reference's routing steps in numpy on ``probs`` (N, E): top-k
    with ties to the lower id, exclusive cumsum ranks in token-major
    (N * K) order, the drop slot.  Returns (eids, slot, capacity)."""
    n = probs.shape[0]
    eids = np.argsort(-probs, axis=-1, kind="stable")[:, :m.top_k]
    cap = max(math.ceil(n * m.top_k / m.n_experts * m.capacity_factor), 4)
    flat = eids.reshape(-1)
    onehot = np.eye(m.n_experts, dtype=np.int64)[flat]
    ranks = (np.cumsum(onehot, 0) - onehot)[np.arange(flat.size), flat]
    slot = np.where(ranks >= cap, cap, ranks).reshape(n, m.top_k)
    return eids, slot, cap


def run_both(cf, shared, n, dtype, n_pad=0):
    jcfg, cfg = configs(cf, shared)
    jp, tp = params(shared)
    x = tokens(n, n_pad)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jout, jaux = jax_moe.moe_forward(jp, jnp.asarray(x, jdt), jcfg)
    xt = torch.from_numpy(x).to(dtype)
    out, aux = moe.moe_forward(tp, xt, cfg)
    plan = moe.route(tp["router"], xt.reshape(n, D), cfg.moe)
    return (np.asarray(jout, np.float32), float(jaux), out, float(aux),
            plan, cfg, tp, xt)


CASES = [(cf, shared, n, dtype)
         for cf in (1.25, 4.0) for shared in (0, 1) for n in (8, 40, 512)
         for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize(
    "cf,shared,n,dtype", CASES,
    ids=[f"cf{cf}-shared{s}-n{n}-{str(d)[6:]}" for cf, s, n, d in CASES])
def test_moe_forward_matches_reference(cf, shared, n, dtype):
    jout, jaux, out, aux, plan, cfg, _, _ = run_both(cf, shared, n, dtype)
    assert out.dtype == dtype and out.shape == (1, n, D)
    got = out.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, jout, atol=FP32_ATOL, rtol=0)
    else:
        assert_bf16_close(got, jout)
    assert aux == pytest.approx(jaux, rel=1e-5)
    # the plan: the numpy recomputation, and jax.lax.top_k's ids
    probs = plan.probs.numpy()
    eids, slot, cap = numpy_plan(probs, cfg.moe)
    assert plan.capacity == cap
    np.testing.assert_array_equal(plan.eids.numpy(), eids)
    np.testing.assert_array_equal(plan.slot.numpy(), slot)
    _, jids = jax.lax.top_k(jnp.asarray(probs), K)
    np.testing.assert_array_equal(plan.eids.numpy(), np.asarray(jids))
    dropped = int((plan.slot == cap).sum())
    if cf == 4.0:
        assert dropped == 0
    elif n >= 40:
        assert dropped > 0          # the tight factor really drops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,n_pad", [(8, 5), (40, 24)])
def test_padding_rows_ahead_route_as_the_reference(dtype, n, n_pad):
    """Padding rows before the real rows take capacity first (token-major
    ranks) and change what the real rows get, the same way on both
    sides; zero rows tie across all experts and take experts 0..K-1."""
    jout, _, out, _, plan, cfg, _, _ = run_both(1.25, 0, n, dtype,
                                                n_pad=n_pad)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), jout, atol=FP32_ATOL, rtol=0)
    else:
        assert_bf16_close(out.float().numpy(), jout)
    zero_rows = plan.eids[0:n_pad:2]
    assert (zero_rows == torch.arange(K)).all()
    eids, slot, _ = numpy_plan(plan.probs.numpy(), cfg.moe)
    np.testing.assert_array_equal(plan.slot.numpy(), slot)
    assert int((plan.slot == plan.capacity).sum()) > 0
    # without the padding the real rows route otherwise
    _, _, alone, _, _, _, _, _ = run_both(1.25, 0, n, dtype)
    assert not torch.equal(alone[0, n_pad:], out[0, n_pad:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_calls_are_byte_equal(dtype):
    _, _, out, aux, _, cfg, tp, xt = run_both(1.25, 1, 512, dtype)
    again, aux2 = moe.moe_forward(tp, xt.clone(), cfg)
    assert torch.equal(out.view(torch.uint8), again.view(torch.uint8))
    assert aux == float(aux2)


def _shapes(tree, lead=0):
    if isinstance(tree, dict):
        return {k: _shapes(v, lead) for k, v in tree.items()}
    return tuple(tree.shape[lead:])


def test_init_moe_shapes_and_scales():
    jcfg, cfg = configs(1.25, 1)
    want = _shapes(jax_moe.init_moe(jax.random.PRNGKey(0), jcfg))
    gen = torch.Generator().manual_seed(0)
    got = moe.init_moe(gen, cfg, lead=(3,))
    assert _shapes(got, lead=1) == want
    assert all(t.shape[0] == 3 for t in
               (got["router"], got["w_down"], got["shared"]["w_up"]))
    assert abs(float(got["router"].std()) / 0.02 - 1.0) < 0.05
    assert abs(float(got["w_gate"].std()) * D ** 0.5 - 1.0) < 0.05
