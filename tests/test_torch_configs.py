"""The registry rows beside qwen2-1.5b: llama3.2-3b, mistral-nemo-12b
and llava-next-mistral-7b's language model (uniform dense GQA, head_dim
128, groups of 3 and 4: inside the paged kernel's guards), against the
reference's configs and, at their smoke sizes, the reference's forward
and paged decode step (CPU, the reference's weights converted;
tolerances of tests/test_torch_model.py).  llava's vision tower is a stub
in both packages: ``forward_seq`` projects its embeddings by ``mm_proj``
and prepends them, and real-mode serving takes text tokens only, as the
reference's launcher serves it.  olmoe-1b-7b's row is held in
tests/test_torch_moe_serving.py; the rows of zamba2-7b and rwkv6-1.6b are
held here field for field with their parameter counts, and their models in
tests/test_torch_ssm.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import serve as jax_serve
from repro.models import transformer as jax_T
from repro.models.params import count_params_analytic as jax_count
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.params import count_params_analytic
from test_torch_engine import NEAR_TIE, first_divergence_gap
from test_torch_model import LOGIT_TOL, assert_close_bf16, \
    check_decode_step, check_forward_seq, smoke_models
from test_torch_serve import _launch, swaps_follow_the_clock  # noqa: F401
from torch_threads import one_torch_thread  # noqa: E402,F401

ARCHS = ["llama3.2-3b", "mistral-nemo-12b", "llava-next-mistral-7b"]
LLAVA = "llava-next-mistral-7b"


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return smoke_models(request.param)


@pytest.mark.parametrize("arch", ARCHS + ["zamba2-7b", "rwkv6-1.6b",
                                  "gemma3-12b", "deepseek-v2-236b",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_rows_match_reference(arch, getter):
    want = getattr(jax_configs, getter)(arch)
    got = getattr(configs, getter)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert count_params_analytic(got) == jax_count(want)
    T.check_supported(got)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_is_inside_the_paged_kernels_guards(arch):
    cfg = configs.get_config(arch)
    assert cfg.resolved_head_dim == 128
    # the CUDA wrapper's guards: head_dim 128, a GQA group of at most 8
    assert cfg.n_heads % cfg.n_kv_heads == 0
    assert cfg.n_heads // cfg.n_kv_heads in (3, 4)


def test_smoke_forward_seq_matches_reference(model):
    check_forward_seq(model)


def test_smoke_decode_step_matches_reference(model):
    check_decode_step(model)


@pytest.fixture(scope="module")
def llava():
    return smoke_models(LLAVA)


def test_llava_forward_seq_with_image_embeds_matches_reference(llava):
    """Image embeddings (B, 16, d_embed) projected by ``mm_proj`` and
    prepended to 24 text tokens: logits over all 40 positions and the K
    stack within the tolerances of tests/test_torch_model.py."""
    cfg, jparams, tcfg, tparams = llava
    assert tuple(tparams["mm_proj"]["w"].shape) == (
        cfg.frontend.d_embed, cfg.d_model)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, (2, 24))
    img = rng.standard_normal((2, cfg.frontend.n_tokens,
                               cfg.frontend.d_embed)).astype(np.float32)
    jlogits, (jk, _), _ = jax_T.forward_seq(jparams, cfg, jnp.asarray(toks),
                                            extra_embeds=jnp.asarray(img))
    logits, (k, _), _ = T.forward_seq(tparams, tcfg, torch.from_numpy(toks),
                                   extra_embeds=torch.from_numpy(img))
    assert logits.shape == (2, 24 + cfg.frontend.n_tokens, cfg.vocab_size)
    assert_close_bf16(logits.numpy(), jlogits, LOGIT_TOL)
    assert_close_bf16(k.float().numpy(), jk, 5e-2)


def test_init_params_draws_the_projector():
    cfg = configs.get_smoke_config(LLAVA)
    p = T.init_params(cfg, seed=0, device="cpu")
    w = p["mm_proj"]["w"]
    assert tuple(w.shape) == (cfg.frontend.d_embed, cfg.d_model)
    assert abs(float(w.std()) * cfg.frontend.d_embed ** 0.5 - 1.0) < 0.05
    assert sum(t.numel() for t in jax.tree.leaves(p)) == \
        count_params_analytic(cfg)
    # an audio frontend on a decoder-only config draws no projector, as
    # in the reference (whisper's encoder takes its frames instead)
    audio = dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, kind="audio"))
    T.check_supported(audio)
    p = T.init_params(audio, seed=0, device="cpu")
    assert "mm_proj" not in p
    assert sum(t.numel() for t in jax.tree.leaves(p)) == \
        count_params_analytic(audio) == jax_count(audio)


def test_llava_real_launcher_matches_reference(llava, tmp_path, capsys,
                                               monkeypatch,
                                               swaps_follow_the_clock):
    """The launcher's real online smoke on llava's smoke config, both on
    the reference's weights for seed 0: results, printed lines and event
    log equal; each conversation's tokens equal the reference engine's,
    or differ first at a near-tie of the port's dense forward."""
    import repro.core as jax_core
    import repro_torch.core as torch_core
    _, _, tcfg, tparams = llava
    engines = {"ref": [], "port": []}
    for key, module in (("ref", jax_core), ("port", torch_core)):
        base = module.ServingEngine

        class Recorded(base):
            def __init__(self, *a, _seen=engines[key], **k):
                super().__init__(*a, **k)
                _seen.append(self)
        monkeypatch.setattr(module, "ServingEngine", Recorded)
    # the launcher draws its serving copy with ``init_params(serving=True)``
    monkeypatch.setattr(
        T, "init_params", lambda cfg, seed, device, serving=False:
        T.serving_params(tparams) if serving else tparams)
    argv = ["--online", "--smoke", "--real", "--arch", LLAVA]
    want, want_ev, want_lines = _launch(jax_serve, argv, tmp_path, "ref",
                                        capsys, monkeypatch)
    got, got_ev, got_lines = _launch(serve, [*argv, "--device", "cpu"],
                                     tmp_path, "port", capsys, monkeypatch)
    got.pop("kernel_launches")
    got.pop("token_histories")
    assert got == want and got_ev == want_ev and got_lines == want_lines
    (ref,), (port,) = engines["ref"], engines["port"]
    assert set(port._token_hist_by_conv) == set(ref._token_hist_by_conv)
    for cid, jh in ref._token_hist_by_conv.items():
        d = first_divergence_gap(tparams, tcfg, port._token_hist_by_conv[cid],
                                 jh)
        assert d is None or d[1] < NEAR_TIE, (cid, d)
