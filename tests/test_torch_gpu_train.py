"""Card tests of the training path: qwen2-1.5b at full width (d_model
1536, 12 / 2 heads of 128, d_ff 8960, vocab 151936, tied embeddings) cut
to 2 layers, random weights from a seed.

  * ``loss_and_grads`` with remat on and off on the card: equal losses,
    gradients within ``chip_smoke.REMAT_GRAD_RTOL``;
  * the card against the CPU on the same parameters and batch: the loss
    and every gradient leaf within chip_smoke's ``TRAIN_LOSS_RTOL`` /
    ``TRAIN_GRAD_RTOL``, then one ``train_step`` on each;
  * a checkpoint round trip of a card tree (smoke size: parameters and
    the AdamW state after one step) through ``.npz``, byte for byte and
    back onto the card.

Marked ``gpu``; each test skips when ``torch.cuda.is_available()`` is
false (decided in the ``cuda`` fixture, never at import):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_train.py
"""
import dataclasses
import os
import sys

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import adamw_init, tree_leaves, tree_map

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def two_layers():
    """qwen2-1.5b at full width with 2 layers, its params drawn on the CPU,
    and a batch of B 2 x T 64."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    params = T.init_params(cfg, seed=0, device="cpu")
    return cfg, params, chip_smoke._train_batch(cfg, 2, 64, "cpu")


def test_remat_on_and_off_agree_on_the_card(cuda, two_layers):
    cfg, params, data = two_layers
    params = tree_map(lambda t: t.to(cuda), params)
    data = {k: v.to(cuda) for k, v in data.items()}
    l1, g1 = S.loss_and_grads(params, cfg, data, remat=True)
    l0, g0 = S.loss_and_grads(params, cfg, data, remat=False)
    assert float(l1) == float(l0)
    errs = chip_smoke._grad_errors(g1, g0)
    assert max(errs.values()) <= chip_smoke.REMAT_GRAD_RTOL, errs


def test_card_agrees_with_the_cpu(cuda, two_layers):
    cfg, params, data = two_layers
    cl, cg = S.loss_and_grads(params, cfg, data)
    dparams = tree_map(lambda t: t.to(cuda), params)
    ddata = {k: v.to(cuda) for k, v in data.items()}
    dl, dg = S.loss_and_grads(dparams, cfg, ddata)
    assert abs(float(dl) - float(cl)) / abs(float(cl)) \
        <= chip_smoke.TRAIN_LOSS_RTOL
    errs = chip_smoke._grad_errors(dg, cg)
    assert max(errs.values()) <= chip_smoke.TRAIN_GRAD_RTOL, errs
    # one step on each: the same loss, and the parameters moved by lr
    # per element at most (a gradient sign the two round apart moves a
    # weight 2 * lr apart)
    cp, _, _ = S.train_step(params, adamw_init(params), data, cfg=cfg)
    dp, dopt, _ = S.train_step(dparams, adamw_init(dparams), ddata,
                               cfg=cfg)
    assert int(dopt.step) == 1
    for a, b in zip(tree_leaves(dp), tree_leaves(cp)):
        assert float((a.cpu() - b).abs().max()) <= 2 * 3e-4 * (1 + 1e-3)


def test_checkpoint_roundtrip_of_a_card_tree(cuda, tmp_path):
    cfg = get_smoke_config("qwen2-1.5b")
    params, opt = S.init_train_state(cfg, seed=0, device=cuda)
    data = chip_smoke._train_batch(cfg, 2, 16, cuda)
    params, opt, _ = S.train_step(params, opt, data, cfg=cfg)
    for name, tree in (("params", params), ("opt", opt)):
        path = str(tmp_path / f"{name}.npz")
        ckpt.save_checkpoint(path, tree)
        back = ckpt.load_checkpoint(path, tree)
        for a, b in zip(tree_leaves(tree), tree_leaves(back)):
            assert b.device.type == "cuda" and b.dtype == a.dtype
            assert torch.equal(a, b)
        cpu_like = tree_map(lambda t: t.cpu(), tree) if name == "params" \
            else opt._replace(step=opt.step.cpu(),
                              mu=tree_map(lambda t: t.cpu(), opt.mu),
                              nu=tree_map(lambda t: t.cpu(), opt.nu))
        on_cpu = ckpt.load_checkpoint(path, cpu_like)
        for a, b in zip(tree_leaves(tree), tree_leaves(on_cpu)):
            assert b.device.type == "cpu" and torch.equal(a.cpu(), b)
