"""The registry rows beside qwen2-1.5b, llama3.2-3b and mistral-nemo-12b
(uniform dense GQA, head_dim 128, groups of 3 and 4: inside the paged
kernel's guards), against the reference's configs and, at their smoke
sizes, the reference's forward and paged decode step (CPU, the reference's
weights converted; tolerances of tests/test_torch_model.py)."""
import dataclasses

import pytest

from repro import configs as jax_configs
from repro.models.params import count_params_analytic as jax_count
from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.models.params import count_params_analytic
from test_torch_model import check_decode_step, check_forward_seq, \
    smoke_models

ARCHS = ["llama3.2-3b", "mistral-nemo-12b"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return smoke_models(request.param)


@pytest.mark.parametrize("arch", ARCHS)
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
