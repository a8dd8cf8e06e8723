"""Card tests of the last three families (smoke configs of gemma3-12b,
deepseek-v2-236b and whisper-large-v3, random weights from a seed),
each held to the same computation on the CPU:

  * ``forward_seq`` logits and caches;
  * ``prefill`` -> ``caches_from_prefill`` -> ``serve_step``s fed the
    CPU's tokens: gemma3 from a prompt past its window of 64 (its rings
    rolled) across a slot wrap, deepseek's absorbed MLA decode, whisper's
    cross caches;
  * the gradients of ``lm_loss`` (relative L2 per leaf);
  * the bf16 serving init equals ``serving_params`` of the fp32 init on
    the card, leaf for leaf, for every arch of the registry; AdamW in
    chunks equals AdamW per leaf, byte for byte.

Model outputs are held to tests/test_torch_model.py's bf16 bounds
(logits 3e-2 per element and 5e-3 on the mean; bf16 caches 5e-2):
cuBLAS and the CPU round bf16 products in other orders, as the port and
the reference do.  A deepseek token routed at a near-tie (K-th to
(K+1)-th router probability within 1e-3 on either side) may take another
expert on the card: its logits are exempt.  Gradients: tests/
test_torch_train.py's 4e-2.  Marked ``gpu``; each test skips when
``torch.cuda.is_available()`` is false (decided in the ``cuda`` fixture,
never at import):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_families.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.models import moe
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt

pytestmark = pytest.mark.gpu

ARCHS = ["gemma3-12b", "deepseek-v2-236b", "whisper-large-v3"]
LOGIT_TOL, MEAN_TOL, KV_TOL = 3e-2, 5e-3, 5e-2
GRAD_RTOL = 4e-2
ROUTE_TIE = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(arch, device):
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    return cfg, params, opt.tree_map(lambda t: t.to(device), params)


def _frames(cfg, B, device=None):
    if not cfg.encoder_decoder:
        return {}
    f = 0.5 * torch.randn((B, cfg.n_encoder_tokens, cfg.d_model),
                          generator=torch.Generator().manual_seed(3))
    return {"encoder_frames": f if device is None else f.to(device)}


def _close(got, want, tol, mean_tol=MEAN_TOL, keep=None):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if keep is not None:
        got, want = got[keep], want[keep]
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert float(np.abs(got - want).mean()) < mean_tol


class _Gaps:
    """Within the block, the rows of each MoE call routed at a near-tie."""

    def __enter__(self):
        self.tied, self.real = [], moe.route

        def route(router, xf, m):
            plan = self.real(router, xf, m)
            top = torch.sort(plan.probs, dim=-1, descending=True).values
            self.tied.append(
                (top[:, m.top_k - 1] - top[:, m.top_k] < ROUTE_TIE).cpu())
            return plan
        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self.real

    def rows(self, n):
        tied = torch.zeros(n, dtype=torch.bool)
        for t in self.tied:
            tied |= t
        return ~tied.numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_seq_matches_the_cpu(cuda, arch):
    cfg, cpu_params, params = _model(arch, cuda)
    T_ = 72 if cfg.sliding_window else 24
    toks = torch.randint(1, cfg.vocab_size, (2, T_),
                         generator=torch.Generator().manual_seed(2))
    with _Gaps() as g:
        logits, caches, _ = T.forward_seq(params, cfg, toks.to(cuda),
                                          **_frames(cfg, 2, cuda))
    want, wcaches, _ = T.forward_seq(cpu_params, cfg, toks,
                                     **_frames(cfg, 2))
    keep = g.rows(2 * T_).reshape(2, T_)
    _close(logits, want, LOGIT_TOL, keep=keep)
    flat = lambda c: (list(c["first"]) + list(c["rest"])
                      if isinstance(c, dict) else list(c))
    for got, w in zip(flat(caches), flat(wcaches)):
        _close(got, w, KV_TOL)


@pytest.mark.parametrize("arch,plen,steps", [("gemma3-12b", 70, 4),
                                             ("gemma3-12b", 60, 6),
                                             ("deepseek-v2-236b", 16, 4),
                                             ("whisper-large-v3", 16, 4)])
def test_prefill_and_decode_match_the_cpu(cuda, arch, plen, steps):
    """``prefill``, ``caches_from_prefill`` to plen + 8 positions and
    ``steps`` ``serve_step``s fed the CPU's tokens: logits and every
    cache leaf (gemma3 60 + 6 writes slots 60..63, then 0, 1)."""
    cfg, cpu_params, params = _model(arch, cuda)
    toks = torch.randint(1, cfg.vocab_size, (2, plen),
                         generator=torch.Generator().manual_seed(plen))
    with _Gaps() as g:
        last, raw = S.prefill(params, cfg, toks.to(cuda),
                              **_frames(cfg, 2, cuda))
    want, wraw = S.prefill(cpu_params, cfg, toks, **_frames(cfg, 2))
    _close(last, want, LOGIT_TOL,
           keep=g.rows(2 * plen).reshape(2, plen)[:, -1])
    caches = S.caches_from_prefill(cfg, raw, 2, plen + 8)
    wcaches = S.caches_from_prefill(cfg, wraw, 2, plen + 8)
    for got, w in zip(caches, wcaches):
        _close(got, w, KV_TOL)
    tok = torch.argmax(want, -1)
    for i in range(steps):
        with _Gaps() as g:
            _, logits, caches = S.serve_step(params, caches, tok.to(cuda),
                                             plen + i, cfg=cfg)
        tok, wlogits, wcaches = S.serve_step(cpu_params, wcaches, tok,
                                             plen + i, cfg=cfg)
        keep = g.rows(2)
        if keep.any():
            _close(logits, wlogits, LOGIT_TOL, keep=keep)
        for got, w in zip(caches, wcaches):
            _close(got, w, KV_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_the_cpu(cuda, arch):
    cfg, cpu_params, params = _model(arch, cuda)
    gen = torch.Generator().manual_seed(4)
    base = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
    batch = {"tokens": base[:, :-1], "labels": base[:, 1:],
             **_frames(cfg, 2)}
    wl, wg = S.loss_and_grads(cpu_params, cfg, batch)
    dl, dg = S.loss_and_grads(params, cfg,
                              {k: v.to(cuda) for k, v in batch.items()})
    assert abs(float(dl) - float(wl)) <= 1e-3 * abs(float(wl))
    for got, want in zip(opt.tree_leaves(dg), opt.tree_leaves(wg)):
        got, want = got.cpu().double(), want.double()
        norm = float(want.norm())
        if norm == 0.0:
            assert not got.any()
        else:
            assert float((got - want).norm()) / norm < GRAD_RTOL


@pytest.mark.parametrize("arch", list_archs())
def test_serving_init_on_the_card(cuda, arch):
    cfg = get_smoke_config(arch)
    served = T.init_params(cfg, seed=1, device=cuda, serving=True)
    want = T.serving_params(T.init_params(cfg, seed=1, device=cuda))
    for got, w in zip(opt.tree_leaves(served), opt.tree_leaves(want)):
        assert got.dtype == w.dtype and torch.equal(got, w)


def test_adamw_in_chunks_equals_per_leaf(cuda, monkeypatch):
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = {"a": torch.randn((1000, 37), generator=gen, device=cuda),
              "b": torch.randn((5,), generator=gen, device=cuda)}
    grads = opt.tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device=cuda), params)
    outs = []
    for chunk in (opt.ADAMW_CHUNK, 1000):
        monkeypatch.setattr(opt, "ADAMW_CHUNK", chunk)
        p = opt.tree_map(torch.clone, params)
        state = opt.adamw_init(p)
        for _ in range(3):
            p, state = opt.adamw_update(grads, state, p)
        outs.append((p, state))
    for a, b in zip(opt.tree_leaves(outs[0]), opt.tree_leaves(outs[1])):
        assert torch.equal(a, b)
