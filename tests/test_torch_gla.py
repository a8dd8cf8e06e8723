"""repro_torch's gated-linear-attention engine (``models/gla.py``) against
the JAX package's (CPU, the same numpy inputs):

  * ``gla_chunked`` in mamba and rwkv mode, per-channel and scalar decay,
    with and without an initial state and the u-bonus, T a multiple of the
    chunk or not (padded), fp32 and bf16 inputs; and against the port's
    sequential oracle ``gla_scan_ref``;
  * its gradients (autograd against ``jax.grad`` of the reference) with
    respect to every input, finite;
  * ``gla_decode_step`` in both modes;
  * the scalar path against ``ops.gla_scan_scalar``'s plain route (what
    the CUDA kernel is held to) and against ``mamba2.ssd_scan_kernel``,
    the Mamba2 block's route to the kernel (broadcast q and k, T padded
    to a chunk that is a multiple of 4).

Inputs are fp32 where not named, so both packages compute the same fp32
function in other summation orders: y and S are held per element to
``ATOL + RTOL * |ref|`` with RTOL 1e-5 (about 100 fp32 ulps, for sums over
a chunk and the carried state) and ATOL 1e-5 of values of O(1-10); the port
lies within 1.4e-6 (1 + |ref|) of the reference, and the reference
jitted against itself op by op within 3.7e-7.  bf16
inputs round y once to bf16 on each side: one bf16 ulp (2^-7 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gla as jax_gla
from repro_torch.kernels import ops
from repro_torch.models import gla, mamba2
from torch_threads import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-5
BF16_RTOL = 2 ** -7
# gradients: per input, relative L2 of fp32 autograd against jax.grad
# (fp32 sums in other orders; measured up to 5.6e-7)
GRAD_RTOL = 1e-5


def _inputs(seed, B=2, H=3, T=37, N=8, P=6, mode="mamba", scalar=False,
            init=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, N)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, H, T, N)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, H, T, P)).astype(np.float32)
    # log decays in [-1.5, -0.01]: per channel, or one per step (scalar)
    lw = -rng.uniform(0.01, 1.5, (B, H, T, 1 if scalar else N))
    out = {"q": q, "k": k, "v": v, "logw": lw.astype(np.float32)}
    if mode == "rwkv":
        out["u"] = rng.standard_normal((H, N)).astype(np.float32) * 0.5
    if init:
        out["initial_state"] = rng.standard_normal(
            (B, H, N, P)).astype(np.float32)
    return out


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


CASES = [
    # mode, scalar decay, T, chunk, initial state
    ("mamba", True, 40, 16, False),
    ("mamba", True, 32, 16, True),
    ("mamba", False, 37, 8, True),
    ("rwkv", False, 37, 16, False),
    ("rwkv", False, 48, 16, True),
    ("rwkv", True, 21, 8, False),
]


@pytest.mark.parametrize("mode,scalar,T_,chunk,init", CASES)
def test_gla_chunked_matches_reference(mode, scalar, T_, chunk, init):
    x = _inputs(1, T=T_, mode=mode, scalar=scalar, init=init)
    kw = dict(mode=mode, chunk=chunk, scalar_decay=scalar)
    want_y, want_s = jax_gla.gla_chunked(
        **{k: jnp.asarray(v) for k, v in x.items()}, **kw)
    y, s = gla.gla_chunked(**{k: torch.from_numpy(v) for k, v in x.items()},
                           **kw)
    assert y.shape == (2, 3, T_, 6) and s.shape == (2, 3, 8, 6)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    _close(y.numpy(), want_y)
    _close(s.numpy(), want_s)
    # the sequential oracle of both packages
    seq_y, seq_s = gla.gla_scan_ref(
        **{k: torch.from_numpy(v) for k, v in x.items()}, mode=mode)
    _close(y.numpy(), seq_y.numpy(), rtol=1e-4, atol=1e-4)
    _close(s.numpy(), seq_s.numpy(), rtol=1e-4, atol=1e-4)
    jseq_y, _ = jax_gla.gla_scan_ref(
        **{k: jnp.asarray(v) for k, v in x.items()}, mode=mode)
    _close(seq_y.numpy(), jseq_y)


@pytest.mark.parametrize("mode", ["mamba", "rwkv"])
def test_gla_chunked_bf16_inputs_match_reference(mode):
    """bf16 q, k, v (the models' dtype): y in bf16 within one ulp, S in
    fp32 as above."""
    x = _inputs(2, T=40, mode=mode, scalar=mode == "mamba")
    jx = {k: jnp.asarray(v, jnp.bfloat16 if k in "qkv" else jnp.float32)
          for k, v in x.items()}
    tx = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if k in "qkv" else torch.float32)
        for k, v in jx.items()}
    kw = dict(mode=mode, chunk=16, scalar_decay=mode == "mamba")
    want_y, want_s = jax_gla.gla_chunked(**jx, **kw)
    y, s = gla.gla_chunked(**tx, **kw)
    assert y.dtype == torch.bfloat16
    _close(y.float().numpy(), want_y, rtol=BF16_RTOL, atol=ATOL)
    _close(s.numpy(), want_s)


@pytest.mark.parametrize("mode,scalar,init", [("mamba", True, True),
                                              ("mamba", False, False),
                                              ("rwkv", False, True)])
def test_gla_chunked_gradients_match_reference(mode, scalar, init):
    """d/d(every input) of sum(y * wy) + sum(S * ws), T = 37 over chunks
    of 16 (padded): finite, and within ``GRAD_RTOL`` of ``jax.grad``."""
    x = _inputs(3, mode=mode, scalar=scalar, init=init)
    rng = np.random.default_rng(4)
    wy = rng.standard_normal((2, 3, 37, 6)).astype(np.float32)
    ws = rng.standard_normal((2, 3, 8, 6)).astype(np.float32)
    kw = dict(mode=mode, chunk=16, scalar_decay=scalar)
    names = list(x)

    def jloss(*args):
        y, s = jax_gla.gla_chunked(**dict(zip(names, args)), **kw)
        return jnp.sum(y * wy) + jnp.sum(s * ws)
    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(x[n]) for n in names))
    tx = {n: torch.from_numpy(x[n]).requires_grad_(True) for n in names}
    y, s = gla.gla_chunked(**tx, **kw)
    (torch.sum(y * torch.from_numpy(wy))
     + torch.sum(s * torch.from_numpy(ws))).backward()
    for n, w in zip(names, want):
        g = tx[n].grad.numpy()
        assert np.isfinite(g).all(), n
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err < GRAD_RTOL, (n, err)


def test_gla_chunked_gradient_stays_finite_over_long_chunks():
    """Strong decays over a 64-step chunk: L_i - L_j of masked (j > i)
    entries reaches ~+300, whose exp overflows fp32; the exponent clamp
    keeps the backward free of 0 * inf."""
    x = _inputs(5, T=64, N=8, mode="rwkv")
    x["logw"] = (x["logw"] * 8.0).astype(np.float32)     # down to -12
    tx = {n: torch.from_numpy(v).requires_grad_(True) for n, v in x.items()}
    y, s = gla.gla_chunked(**tx, mode="rwkv", chunk=64)
    (y.sum() + s.sum()).backward()
    assert all(torch.isfinite(t.grad).all() for t in tx.values())


@pytest.mark.parametrize("mode", ["mamba", "rwkv"])
@pytest.mark.parametrize("scalar", [False, True])
def test_gla_decode_step_matches_reference(mode, scalar):
    x = _inputs(6, T=1, mode=mode, scalar=scalar, init=True)
    args = {k: v[:, :, 0] if k in ("q", "k", "v", "logw") else v
            for k, v in x.items()}
    S0 = args.pop("initial_state")
    want_y, want_s = jax_gla.gla_decode_step(
        **{k: jnp.asarray(v) for k, v in args.items()}, S=jnp.asarray(S0),
        mode=mode)
    y, s = gla.gla_decode_step(
        **{k: torch.from_numpy(v) for k, v in args.items()},
        S=torch.from_numpy(S0), mode=mode)
    _close(y.numpy(), want_y)
    _close(s.numpy(), want_s)
    # one step of the chunked engine from the same state
    cy, cs = gla.gla_chunked(
        **{k: torch.from_numpy(v) for k, v in x.items()}, mode=mode,
        chunk=1, scalar_decay=scalar)
    _close(y.numpy(), cy[:, :, 0].numpy())
    _close(s.numpy(), cs.numpy())


@pytest.mark.parametrize("T_", [64, 37])
def test_scalar_path_matches_the_kernels_plain_route(T_):
    """``gla_chunked(scalar_decay=True)`` from a zero state against
    ``ops.gla_scan_scalar`` on CPU tensors (its plain version, which the
    CUDA kernel is held to), logw passed as (B, H, T); T 37 through
    ``mamba2.ssd_scan_kernel``, which pads it to the chunk."""
    x = _inputs(7, T=T_, N=16, P=32, scalar=True)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    want_y, want_s = gla.gla_chunked(t["q"], t["k"], t["v"], t["logw"],
                                     chunk=16, scalar_decay=True)
    if T_ % 16 == 0:
        y, s = ops.gla_scan_scalar(t["q"], t["k"], t["v"],
                                   t["logw"][..., 0], chunk=16)
    else:
        y, s = mamba2.ssd_scan_kernel(t["q"], t["k"], t["v"], t["logw"],
                                      16)
    assert y.shape == want_y.shape
    _close(y.numpy(), want_y.numpy())
    _close(s.numpy(), want_s.numpy())


@pytest.mark.parametrize("T_", [3, 6, 37])
def test_ssd_scan_kernel_route_takes_broadcast_inputs(T_):
    """The Mamba2 block's kernel route: q and k broadcast from one group
    across heads (expanded views), bf16, T padded to a chunk that is a
    multiple of 4 (T 3 and 6: chunks 4 and 8, where the reference's
    ``min(chunk, T)`` would give 3 and 6): y within a bf16 ulp, S within
    fp32 bounds of the reference's ``gla_chunked``."""
    rng = np.random.default_rng(8)
    B, H, N, P = 2, 4, 16, 32
    C = rng.standard_normal((B, 1, T_, N)).astype(np.float32) * 0.5
    Bk = rng.standard_normal((B, 1, T_, N)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, H, T_, P)).astype(np.float32)
    lw = -rng.uniform(0.01, 1.5, (B, H, T_, 1)).astype(np.float32)
    jq, jk = (jnp.broadcast_to(jnp.asarray(a, jnp.bfloat16), (B, H, T_, N))
              for a in (C, Bk))
    jv = jnp.asarray(v, jnp.bfloat16)
    want_y, want_s = jax_gla.gla_chunked(jq, jk, jv, jnp.asarray(lw),
                                         chunk=min(16, T_),
                                         scalar_decay=True)
    tb = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16)
    q = tb(jnp.asarray(C, jnp.bfloat16)).expand(B, H, T_, N)
    k = tb(jnp.asarray(Bk, jnp.bfloat16)).expand(B, H, T_, N)
    assert mamba2.kernel_chunk(16, T_) == min(16, 4 * -(-T_ // 4))
    y, s = mamba2.ssd_scan_kernel(q, k, tb(jv), torch.from_numpy(lw), 16)
    assert y.shape == (B, H, T_, P) and y.dtype == torch.bfloat16
    _close(y.float().numpy(), want_y, rtol=BF16_RTOL, atol=ATOL)
    _close(s.numpy(), want_s)
