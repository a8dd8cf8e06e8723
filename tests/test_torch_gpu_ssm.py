"""Card tests of the SSM and hybrid families (smoke configs of zamba2-7b
and rwkv6-1.6b, random weights from a seed; the SSD scan at zamba2-7b's
head shape where named):

  * the Mamba2 block's no-grad sequence forward on CUDA launches the scan
    kernel once and agrees with the same block on the CPU (which runs
    ``gla_chunked``), also for T not a multiple of 4 (the kernel's chunk
    rounded up, T padded);
  * from a given state on CUDA, without a gradient, the block runs
    ``gla_chunked`` (no launch) and agrees with the CPU; with a gradient
    it runs ``gla_chunked`` too (no launch) and its gradients are finite;
  * a kernel that cannot be built raises: no plain fallback;
  * zamba2's ``forward_seq`` / ``prefill`` on the card launch the kernel
    once per Mamba2 layer, and its logits, and rwkv6's, agree with the
    CPU's; ``caches_from_prefill`` -> ``serve_step`` tokens agree.

Model outputs are held to tests/test_torch_model.py's bf16 bounds
(logits 3e-2 per element, 5e-3 on the mean; bf16 activations 5e-2):
cuBLAS and the CPU round bf16 products in other orders, as the port and
the reference do.  Marked ``gpu``; each test skips when
``torch.cuda.is_available()`` is false (decided in the ``cuda`` fixture,
never at import):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_ssm.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import build
from repro_torch.kernels import gla_scan as gla
from repro_torch.kernels import launches
from repro_torch.models import mamba2
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import tree_map

pytestmark = pytest.mark.gpu

LOGIT_TOL, MEAN_TOL, ACT_TOL = 3e-2, 5e-3, 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(arch, device):
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    return cfg, params, tree_map(lambda t: t.to(device), params)


def _close(got, want, tol, mean_tol=MEAN_TOL):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert float(np.abs(got - want).mean()) < mean_tol


def _block(params):
    return {k: t[0, 0] for k, t in params["mamba_p"]["mamba"].items()}


@pytest.mark.parametrize("T_", [64, 37, 3])
def test_mamba2_block_runs_the_kernel_and_matches_the_cpu(cuda, T_):
    cfg, cpu_params, params = _model("zamba2-7b", cuda)
    x = torch.randn((2, T_, cfg.d_model),
                    generator=torch.Generator().manual_seed(T_)).bfloat16()
    launches.reset(gla.gla_scan_scalar)
    with torch.no_grad():
        out, st = mamba2.mamba2_block_forward(_block(params), x.to(cuda),
                                              cfg)
        want, wst = mamba2.mamba2_block_forward(_block(cpu_params), x, cfg)
    assert gla.gla_scan_scalar.launches == 1
    _close(out, want, ACT_TOL)
    _close(st.S, wst.S, 1e-2 * max(1.0, float(wst.S.abs().max())))
    assert torch.equal(st.conv.cpu(), wst.conv)


def test_mamba2_block_refuses_a_state_and_trains_without_the_kernel(cuda):
    """(Named for what it checked before the state route existed.)  From
    a given, non-zero state without a gradient the block runs
    ``gla_chunked``, launches no kernel, and agrees with the CPU; with a
    gradient it trains without the kernel."""
    cfg, cpu_params, params = _model("zamba2-7b", cuda)
    p = _block(params)
    gen = torch.Generator().manual_seed(5)
    x_cpu = torch.randn((2, 16, cfg.d_model), generator=gen).bfloat16()
    st_cpu = mamba2.init_mamba_state(cfg, 2)
    st_cpu = mamba2.MambaState(
        conv=torch.randn(st_cpu.conv.shape, generator=gen).bfloat16(),
        S=0.05 * torch.randn(st_cpu.S.shape, generator=gen))
    x = x_cpu.to(cuda)
    state = mamba2.MambaState(st_cpu.conv.to(cuda), st_cpu.S.to(cuda))
    launches.reset(gla.gla_scan_scalar)
    with torch.no_grad():
        out, st = mamba2.mamba2_block_forward(p, x, cfg, state)
        want, wst = mamba2.mamba2_block_forward(_block(cpu_params), x_cpu,
                                                cfg, st_cpu)
    assert gla.gla_scan_scalar.launches == 0
    _close(out, want, ACT_TOL)
    _close(st.S, wst.S, 1e-2 * max(1.0, float(wst.S.abs().max())))
    assert torch.equal(st.conv.cpu(), wst.conv)
    leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
    out, st = mamba2.mamba2_block_forward(leaves, x, cfg, state)
    (out.float().sum() + st.S.sum()).backward()
    assert gla.gla_scan_scalar.launches == 0
    assert all(torch.isfinite(t.grad).all() for t in leaves.values())


def test_a_scan_kernel_that_cannot_be_built_raises(cuda, monkeypatch):
    cfg, _, params = _model("zamba2-7b", cuda)
    x = torch.randn((1, 16, cfg.d_model), device=cuda).bfloat16()

    def broken(name):
        raise RuntimeError(f"{name}: nvcc failed")
    monkeypatch.setattr(build, "library", broken)
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc failed"):
        mamba2.mamba2_block_forward(_block(params), x, cfg)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_prefill_and_decode_match_the_cpu(cuda, arch):
    """``prefill`` of 2 prompts of 24 (zamba2: one scan launch per Mamba2
    layer), ``caches_from_prefill`` to 32 positions and 4 ``serve_step``s
    fed the CPU's tokens: logits within the bf16 bounds."""
    cfg, cpu_params, params = _model(arch, cuda)
    toks = torch.randint(1, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    launches.reset(gla.gla_scan_scalar)
    last, raw = S.prefill(params, cfg, toks.to(cuda))
    R, P, rem = T._zamba2_shape(cfg)
    n_mamba = P * R + rem if arch == "zamba2-7b" else 0
    assert gla.gla_scan_scalar.launches == n_mamba
    want, wraw = S.prefill(cpu_params, cfg, toks)
    _close(last, want, LOGIT_TOL)
    caches = S.caches_from_prefill(cfg, raw, 2, 32)
    wcaches = S.caches_from_prefill(cfg, wraw, 2, 32)
    tok = torch.argmax(want, -1)
    for i in range(4):
        _, logits, caches = S.serve_step(params, caches, tok.to(cuda),
                                         24 + i, cfg=cfg)
        tok, wlogits, wcaches = S.serve_step(cpu_params, wcaches, tok,
                                             24 + i, cfg=cfg)
        _close(logits, wlogits, LOGIT_TOL)
