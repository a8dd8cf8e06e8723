"""mistral-nemo-12b's attention geometry through both packages: its query
heads span n_heads x head_dim = 4096 of a d_model of 5120 (head_dim 128,
not d_model / n_heads = 160), the one paged config where the two differ.
Every reduced config has 256 / 4 = 64, so no other test serves that
geometry at a small size.

A reduced nemo that keeps it, d_model 320 with 4 / 2 heads of 64 (256 of
320), 2 layers, vocab 512, built by each package from its own registry
config (``get_config("mistral-nemo-12b").reduced(...)``), the reference's
weights (``init_params(cfg, PRNGKey(0))``) converted for the port:

  * the dense forward, the reference op by op (``jax.disable_jit``) against
    the port, every logit within a bf16 tolerance;
  * the system suite's workload (``tests/test_torch_system.py``'s
    ``_agree_run``: 4 conversations, 48 GPU blocks, a random priority
    trace) under each policy of the paper's ladder (``POLICY_ORDER``)
    through the port's engine, its histories held with
    ``assert_histories_agree`` to the reference engine's runs under
    vllm and fastswitch (equal, or first different at a near-tie of the
    port's logits).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import EngineConfig as JaxEngineConfig
from repro.core import FastSwitchEngine as JaxFastSwitchEngine
from repro.data.priority import PriorityTrace as JaxPriorityTrace
from repro.data.sharegpt import sample_conversations as jax_conversations
from repro.models import transformer as jax_T
from repro_torch.configs import get_config
from repro_torch.launch.scenarios import POLICY_ORDER
from repro_torch.models import transformer as T
from test_torch_system import _agree_run
from torch_parity import assert_histories_agree
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "mistral-nemo-12b"
GEOMETRY = dict(name="mistral-nemo-12b-geometry", n_layers=2, d_model=320,
                n_heads=4, n_kv_heads=2, head_dim=64, d_ff=640,
                vocab_size=512, max_seq_len=1024)
# the port's bf16 ops against the reference's op by op: each side rounds
# every bf16 product once, from fp32 sums taken in other orders, so a
# logit may move by the rounding of its last activations (~2^-8 of their
# scale, ~0.01 here); a head reading the wrong columns of wo moves
# logits by O(1)
LOGIT_ATOL = 2e-2


@functools.lru_cache(maxsize=None)
def bundles():
    """(reference bundle, port bundle) of the geometry, each config from
    its own package's registry entry."""
    jcfg = jax_get_config(ARCH).reduced(**GEOMETRY)
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = T.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    return ({"cfg": jcfg, "params": jparams},
            {"cfg": get_config(ARCH).reduced(**GEOMETRY),
             "params": tparams})


def test_the_geometry_keeps_nemos_head_dim():
    jb, tb = bundles()
    for cfg in (jb["cfg"], tb["cfg"]):
        assert cfg.head_dim * cfg.n_heads != cfg.d_model
        assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) \
            == (320, 4, 2, 64)
    assert tb["params"]["layers"]["attn"]["wo"].shape[-2:] == (256, 320)
    full = get_config(ARCH)
    assert full.head_dim * full.n_heads != full.d_model


def test_dense_forward_matches_the_reference_op_by_op():
    jb, tb = bundles()
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (2, 96))
    with jax.disable_jit():
        jl, _, _ = jax_T.forward_seq(jb["params"], jb["cfg"],
                                     jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        tl, _, _ = T.forward_seq(tb["params"], tb["cfg"],
                                 torch.from_numpy(toks))
    jl = np.asarray(jl, np.float32)
    np.testing.assert_allclose(tl.float().numpy(), jl, atol=LOGIT_ATOL,
                               rtol=0)
    assert float(np.mean(tl.float().numpy().argmax(-1) == jl.argmax(-1))) \
        > 0.95


@functools.lru_cache(maxsize=None)
def reference_runs() -> dict:
    """The reference engine's histories of the system suite's workload
    under the reference case's pair, vllm and fastswitch."""
    jb, _ = bundles()
    return {pol: _agree_run(pol, jb, JaxEngineConfig, JaxFastSwitchEngine,
                            JaxPriorityTrace, jax_conversations)
            for pol in ("vllm", "fastswitch")}


@pytest.mark.parametrize("pol", POLICY_ORDER)
def test_policies_agree_with_the_reference_engine(pol):
    _, tb = bundles()
    ours = _agree_run(pol, tb)
    equal = sum(assert_histories_agree(tb, ours, want)
                for want in reference_runs().values())
    print(f"{pol}: {equal} of {2 * len(ours)} streams equal the reference "
          "engine's")
