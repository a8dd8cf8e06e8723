"""repro_torch's training path against the JAX package's (CPU, smoke
configs, the reference's weights converted with ``params_from_numpy``,
the same numpy inputs):

  * ``adamw_update`` on random trees over 3 steps;
  * ``chunked_ce_loss`` with chunks shorter than the sequence and -1
    labels, and its gradients;
  * ``lm_loss`` and its gradients (remat on; on the port's side remat
    off gives the same bytes), and one
    ``train_step``'s new parameters and optimizer state, for each of the
    five archs: dense GQA, olmoe's MoE (its aux loss counted) and llava
    (the image positions not scored);
  * checkpoints: files either package writes load in the other byte for
    byte, under the same keys, and the port's own round trip;
  * the launcher ``python -m repro_torch.launch.train --device cpu``,
    also with ``jax`` blocked.

The reference runs op by op (``jax.disable_jit``), which rounds every
bf16 op as the port does (jitted, XLA keeps fused bf16 intermediates in
fp32, and flips MoE routing near-ties: tests/test_torch_moe_serving.py).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import steps as jax_S
from repro.models import transformer as jax_T
from repro.train import checkpoint as jax_ckpt
from repro.train import optimizer as jax_opt
from repro_torch import configs
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.models.paged import supports_paged
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from test_torch_model import smoke_models
from torch_threads import one_torch_thread  # noqa: E402,F401

# the uniform GQA decoders; the SSM and hybrid families (zamba2, rwkv)
# are held in tests/test_torch_ssm.py and tests/test_torch_ssm_train.py,
# gemma3, deepseek-v2 (MLA) and whisper (encoder-decoder) in
# tests/test_torch_families.py and tests/test_torch_families_train.py
ARCHS = [a for a in configs.list_archs()
         if supports_paged(configs.get_config(a))]
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# The loss is a mean of fp32 log-probabilities over bf16 hidden states:
# the two packages' losses lie 4e-6 to 2.6e-5 apart (relative) on the
# five smoke configs; dropping the MoE aux loss moves olmoe's by 3e-3.
LOSS_RTOL = 1e-4
# Per gradient leaf, |g - g_ref| / |g_ref| (L2 norms).  bf16 activations
# and cotangents round at every op: the port against the op-by-op
# reference measured 0.004-0.017 on the five smoke configs, and the
# reference jitted against itself op by op up to 0.020 (XLA's fp32
# intermediates).  The bound is twice the reference's own spread.
GRAD_RTOL = 4e-2
# AdamW arithmetic is fp32 elementwise in the same order on both sides;
# the bias corrections' powers and divisions may round apart by an ulp.
ADAM_RTOL, ADAM_ATOL = 2e-6, 1e-9


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _paths(tree):
    """(key string, numpy leaf) of a reference tree."""
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _at(tree, keystr: str):
    """The port tree's leaf under a reference key string like
    "['layers']['attn']['wq']"."""
    for k in keystr[2:-2].split("']['"):
        tree = tree[k]
    return tree


def _batch(cfg, seed: int = 5, B: int = 2, T_: int = 24):
    """numpy batch: (B, T_ + 1) tokens split into tokens and labels (some
    labels -1), and image embeddings for a VLM."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T_ + 1))
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    b["labels"][0, :3] = -1
    if cfg.frontend is not None:
        b["extra_embeds"] = (rng.standard_normal(
            (B, cfg.frontend.n_tokens, cfg.frontend.d_embed)) * 0.5
        ).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return smoke_models(request.param)


def test_adamw_matches_reference_over_three_steps():
    rng = np.random.default_rng(0)
    shapes = {"a": {"w": (5, 7), "b": (7,)}, "c": (3, 4, 2)}
    make = lambda s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    p0 = jax.tree.map(make, shapes, is_leaf=lambda x: isinstance(x, tuple))
    jp, js = p0, jax_opt.adamw_init(p0)
    tp = T.params_from_numpy(p0, device="cpu")
    ts = opt.adamw_init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * 10.0 ** -i).astype(np.float32), p0)
        g["c"][0] = 0.0                        # zero gradients stay finite
        jp, js = jax_opt.adamw_update(g, js, jp, lr=1e-2)
        tp, ts = opt.adamw_update(T.params_from_numpy(g, device="cpu"), ts,
                                  tp, lr=1e-2)
        assert int(ts.step) == int(js.step) == i + 1
        for name, jt, tt in (("params", jp, tp), ("mu", js.mu, ts.mu),
                             ("nu", js.nu, ts.nu)):
            for key, want in _paths(jt):
                np.testing.assert_allclose(_at(tt, key).numpy(), want,
                                           rtol=ADAM_RTOL, atol=ADAM_ATOL,
                                           err_msg=f"{name}{key} step {i}")


@pytest.mark.parametrize("T_", [37, 64])
def test_chunked_ce_loss_matches_reference(T_):
    """Chunks of 16 over 37 positions (the last chunk padded) and over
    64 (no pad), some labels -1: the loss and its gradients w.r.t. the
    bf16 hidden states and the fp32 table."""
    rng = np.random.default_rng(1)
    B, d, V = 2, 32, 50
    jh = jnp.asarray(rng.standard_normal((B, T_, d)), jnp.bfloat16)
    table = (rng.standard_normal((V, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, T_))
    labels[1, ::3] = -1
    with jax.disable_jit():
        jl, (jgh, jgt) = jax.value_and_grad(
            lambda h, w: jax_S.chunked_ce_loss(h, w, jnp.asarray(labels),
                                               chunk=16),
            argnums=(0, 1))(jh, jnp.asarray(table))
    h = torch.from_numpy(np.asarray(jh, np.float32)).to(torch.bfloat16)
    h.requires_grad_(True)
    w = torch.from_numpy(table).requires_grad_(True)
    loss = S.chunked_ce_loss(h, w, torch.from_numpy(labels), chunk=16)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(h.grad.float().numpy(),
                               np.asarray(jgh, np.float32), rtol=2 ** -7,
                               atol=1e-7)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jgt), rtol=1e-5,
                               atol=1e-7)


def _check_grads(tgrads, jgrads):
    worst = max((_rel(_at(tgrads, k).numpy(), v), k)
                for k, v in _paths(jgrads))
    assert worst[0] < GRAD_RTOL, worst
    assert len(opt.tree_leaves(tgrads)) == len(jax.tree.leaves(jgrads))


def test_lm_loss_and_grads_match_reference(model):
    """``lm_loss`` with remat on (``train_step``'s default; remat off
    gives the same numbers: the test below) and its gradient tree."""
    cfg, jparams, tcfg, tparams = model
    jb, tb = _batch(cfg)
    with jax.disable_jit():
        jl, jg = jax.value_and_grad(
            lambda p: jax_S.lm_loss(p, cfg, jb, remat=True))(jparams)
    tl, tg = S.loss_and_grads(tparams, tcfg, tb, remat=True)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    with torch.no_grad():
        assert float(S.lm_loss(tparams, tcfg, tb)) == float(tl)
    _check_grads(tg, jg)
    assert not any(t.requires_grad for t in opt.tree_leaves(tparams))


def test_remat_changes_no_loss_or_gradient(model):
    """Recomputing each layer in the backward pass gives the same loss
    and, on the CPU, the same gradients byte for byte."""
    _, _, tcfg, tparams = model
    _, tb = _batch(tcfg, seed=6)
    l1, g1 = S.loss_and_grads(tparams, tcfg, tb, remat=True)
    l0, g0 = S.loss_and_grads(tparams, tcfg, tb, remat=False)
    assert float(l1) == float(l0)
    for a, b in zip(opt.tree_leaves(g1), opt.tree_leaves(g0)):
        assert torch.equal(a, b)


def test_train_step_matches_reference(model):
    """One ``train_step`` (lr 3e-4, remat on): the loss, the new
    parameters, moments and step.  AdamW's first step moves each weight
    by lr * (g / (|g| + eps) + wd * p), so a gradient whose sign the two
    packages' bf16 rounding flips moves it 2 * lr apart: the parameters
    are held to 2 * lr per element (and equal where |g| is clear of
    the rounding), the moments to the gradients' bound."""
    cfg, jparams, tcfg, tparams = model
    jb, tb = _batch(cfg, seed=7)
    with jax.disable_jit():
        jp, js, jl = jax_S.train_step(jparams, jax_opt.adamw_init(jparams),
                                      jb, cfg=cfg)
    tp, ts, tl = S.train_step(
        T.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        opt.adamw_init(tparams), tb, cfg=tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert int(ts.step) == int(js.step) == 1
    flips = 0
    for key, want in _paths(jp):
        got = _at(tp, key).numpy()
        diff = np.abs(got - want)
        assert diff.max() <= 2 * 3e-4 * (1 + 1e-3), key
        flips += int((diff > 3e-4).sum())
    n = sum(v.size for v in jax.tree.leaves(jp))
    assert flips < 0.01 * n, (flips, n)
    _check_grads(ts.mu, js.mu)
    for key, want in _paths(js.nu):
        assert _rel(_at(ts.nu, key).numpy(), want) < 2 * GRAD_RTOL, key


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """qwen2-1.5b's smoke params and AdamW state after one reference
    step, in both packages (the port's converted leaf by leaf)."""
    cfg, jparams, tcfg, _ = smoke_models("qwen2-1.5b")
    jb, _ = _batch(cfg, seed=8)
    jp, js, _ = jax.jit(lambda p, o: jax_S.train_step(p, o, jb, cfg=cfg))(
        jparams, jax_opt.adamw_init(jparams))
    tp = T.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = opt.AdamWState(
        step=torch.tensor(int(js.step), dtype=torch.int32),
        mu=T.params_from_numpy(jax.tree.map(np.asarray, js.mu), "cpu"),
        nu=T.params_from_numpy(jax.tree.map(np.asarray, js.nu), "cpu"))
    return jp, js, tp, ts


def _equal_trees(jtree, ttree):
    jflat = _paths(jtree._asdict() if hasattr(jtree, "_asdict") else jtree)
    for key, want in jflat:
        got = _at(ttree._asdict() if hasattr(ttree, "_asdict") else ttree,
                  key).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("which", ["params", "adamw_state"])
def test_checkpoints_load_across_packages(trained, tmp_path, which):
    """The reference's file loads into the port's tree byte for byte, the
    port's into the reference's, and both write the same keys."""
    jp, js, tp, ts = trained
    jtree, ttree = (jp, tp) if which == "params" else (js, ts)
    jpath, tpath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jax_ckpt.save_checkpoint(jpath, jtree)
    ckpt.save_checkpoint(tpath, ttree)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        if which == "adamw_state":
            assert ".step" in a.files and ".mu/embed/table" in a.files
        else:
            assert "layers/attn/wq" in a.files
    zeros = jax.tree.map(torch.zeros_like, ttree)
    _equal_trees(jtree, ckpt.load_checkpoint(jpath, zeros))
    _equal_trees(jax_ckpt.load_checkpoint(tpath, jtree), ttree)
    if which == "adamw_state":
        restored = ckpt.load_checkpoint(jpath[:-4], zeros)  # no suffix
        assert isinstance(restored, opt.AdamWState)
        assert restored.step.dtype == torch.int32 and int(restored.step) == 1


def test_checkpoint_roundtrip(tmp_path):
    """The port's save/load, as tests/test_launchers.py holds the
    reference's: llama3.2-3b's smoke params, and the optimizer state
    after one step."""
    cfg = configs.get_smoke_config("llama3.2-3b")
    params = T.init_params(cfg, seed=3, device="cpu")
    path = str(tmp_path / "ckpt.npz")
    ckpt.save_checkpoint(path, params)
    restored = ckpt.load_checkpoint(path, params)
    flat1, flat2 = opt.tree_leaves(params), opt.tree_leaves(restored)
    assert len(flat1) == len(flat2)
    for a, b in zip(flat1, flat2):
        assert torch.equal(a, b)
    cfg = configs.get_smoke_config("qwen2-1.5b")
    params, state = S.init_train_state(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    params, state, _ = S.train_step(params, state,
                                    {"tokens": tokens, "labels": tokens},
                                    cfg=cfg)
    path = str(tmp_path / "opt.npz")
    ckpt.save_checkpoint(path, state)
    back = ckpt.load_checkpoint(path, state)
    assert int(back.step) == 1
    for a, b in zip(opt.tree_leaves(state), opt.tree_leaves(back)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _run(args, timeout=300, prelude=""):
    """``python -m repro_torch.launch.train ARGS`` (after ``prelude``) in
    a subprocess from the repo root, one OpenMP thread."""
    code = prelude + textwrap.dedent("""
        import sys
        from repro_torch.launch import train
        train.main(sys.argv[1:])
    """)
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-c", code, *args], env=env,
                          cwd=os.path.join(SRC, ".."), capture_output=True,
                          text=True, timeout=timeout)


def test_train_cli_cpu(tmp_path):
    """The reference's ``test_train_cli`` arguments plus ``--device cpu``
    and ``--checkpoint``: exit 0, the reference's lines, and a params
    file that loads into both packages' trees."""
    path = str(tmp_path / "ckpt.npz")
    r = _run(["--device", "cpu", "--arch", "qwen2-1.5b", "--steps", "3",
              "--batch", "2", "--seq", "32", "--checkpoint", path])
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    cfg = configs.get_smoke_config("qwen2-1.5b")
    n = sum(t.numel() for t in opt.tree_leaves(
        T.init_params(cfg, device="cpu")))
    assert lines[0] == f"arch={cfg.name} params={n:,}"
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [int(ln.split()[1]) for ln in steps] == [0, 2]
    assert all(np.isfinite(float(ln.split()[3])) for ln in steps)
    assert lines[-1] == f"saved {path}"
    like = T.init_params(cfg, seed=1, device="cpu")
    got = ckpt.load_checkpoint(path, like)
    assert not torch.equal(got["embed"]["table"], like["embed"]["table"])
    jlike = jax_T.init_params(jax_smoke_config("qwen2-1.5b"),
                              jax.random.PRNGKey(0))
    jgot = jax_ckpt.load_checkpoint(path, jlike)
    _equal_trees(jgot, got)


def test_train_cli_runs_with_jax_blocked():
    """The launcher and the modules it imports (``models.steps``,
    ``train.optimizer``, ``train.checkpoint``) run a step with ``jax``
    unimportable and load no ``repro`` module; ``--device cuda`` without a
    GPU exits non-zero."""
    block = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None           # any `import jax` now fails
        import atexit
        atexit.register(lambda: print("repro loaded:", sorted(
            n for n in sys.modules if n == "repro" or n.startswith("repro."))))
    """)
    r = _run(["--device", "cpu", "--arch", "olmoe-1b-7b", "--steps", "1",
              "--batch", "2", "--seq", "16"], prelude=block)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "step     0 loss" in r.stdout
    assert r.stdout.splitlines()[-1] == "repro loaded: []"
    if not torch.cuda.is_available():
        r = _run(["--steps", "1"], prelude=block)
        assert r.returncode != 0
        assert "torch.cuda.is_available() is false" in r.stderr
