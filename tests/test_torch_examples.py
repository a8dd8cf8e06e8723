"""The port's examples against the reference's (CPU, smoke configs):

  * ``examples/torch_quickstart.py``'s engine (``build("cpu")``, the
    reference's ``init_params(cfg, PRNGKey(0))`` converted with
    ``params_from_numpy``) against the reference engine built as
    ``examples/quickstart.py`` builds it, both packages' swap tasks held
    to the simulated clock: ``metrics.summary()`` and ``swap.stats()``
    equal (144 tokens, 144 iterations, 12 preemptions, 18 swap ops), and
    each conversation's greedy history equal or first apart at a near-tie
    of the port's dense forward;
  * ``python examples/torch_quickstart.py --device cpu`` exits 0 with the
    reference quickstart's lines, jax blocked;
  * ``examples/torch_train_lm.py``: each of 5 steps' loss against the
    reference's jitted ``train_step`` on the same parameters and batch
    (``tests/test_torch_train.py``'s tolerance), and its checkpoint read
    by the reference's ``load_checkpoint`` key for key.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke_served import ROOT  # noqa: E402,F401
import chip_smoke  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import EngineConfig as JaxEngineConfig
from repro.core import FastSwitchEngine as JaxFastSwitchEngine
from repro.core import swap_manager as jax_swap_manager
from repro.data.priority import PriorityTrace as JaxPriorityTrace
from repro.data.sharegpt import Conversation as JaxConversation
from repro.data.sharegpt import Turn as JaxTurn
from repro.models import steps as jax_S
from repro.models import transformer as jax_T
from repro.train import checkpoint as jax_ckpt
from repro.train import optimizer as jax_opt
from repro_torch.configs import get_smoke_config
from repro_torch.core import swap_manager as torch_swap_manager
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from test_torch_engine import first_divergence_gap
from test_torch_train import LOSS_RTOL
from torch_threads import one_torch_thread  # noqa: E402,F401

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
sys.path.insert(0, EXAMPLES)
import torch_quickstart  # noqa: E402
import torch_train_lm  # noqa: E402

# the port's CPU parity policy (tests/test_torch_engine.py)
NEAR_TIE = 2e-2


def _reference_quickstart(params):
    """The engine of ``examples/quickstart.py``, as it builds it."""
    cfg = jax_smoke_config("llama3.2-3b")
    conversations = [
        JaxConversation(conv_id=i, arrival_s=0.2 * i,
                        turns=[JaxTurn(prompt_tokens=16, response_tokens=12),
                               JaxTurn(prompt_tokens=8, response_tokens=12)],
                        think_time_s=1.0)
        for i in range(6)
    ]
    engine_cfg = JaxEngineConfig(
        mode="real", num_gpu_blocks=96, num_cpu_blocks=512,
        max_running=4, max_batch=4).with_policy("fastswitch")
    return JaxFastSwitchEngine(
        engine_cfg, conversations,
        trace=JaxPriorityTrace("markov", update_freq=0.05, seed=1),
        model_bundle={"cfg": cfg, "params": params})


def test_quickstart_equals_reference():
    jparams = jax_T.init_params(jax_smoke_config("llama3.2-3b"),
                                jax.random.PRNGKey(0))
    tparams = T.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    with chip_smoke.swaps_follow_the_clock(jax_swap_manager,
                                           torch_swap_manager):
        ref = _reference_quickstart(jparams)
        js = ref.run().summary()
        port = torch_quickstart.build("cpu", params=tparams)
        ts = port.run().summary()
    js.pop("callstack_wall_s")
    ts.pop("callstack_wall_s")
    assert ts == js
    assert (ts["total_tokens"], ts["iterations"], ts["preemptions"]) == \
        (144, 144, 12)
    assert port.swap.stats() == ref.swap.stats()
    assert port.swap.stats()["total_ops"] == 18
    assert port.done() and ref.done()
    th, jh = port._token_hist_by_conv, ref._token_hist_by_conv
    assert set(th) == set(jh) == set(range(6))
    cfg = get_smoke_config("llama3.2-3b")
    for cid in sorted(jh):
        d = first_divergence_gap(tparams, cfg, th[cid], jh[cid])
        assert d is None or d[1] < NEAR_TIE, \
            f"conv {cid}: histories diverge at {d[0]} with gap {d[1]}"


def test_quickstart_cli_runs_with_jax_blocked():
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.argv = ['torch_quickstart.py', '--device', 'cpu']\n"
            f"runpy.run_path({os.path.join(EXAMPLES, 'torch_quickstart.py')!r},"
            " run_name='__main__')\n"
            "assert not any(m == 'repro' or m.startswith('repro.')\n"
            "               for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[0].startswith("model: llama3.2-3b-smoke  (")
    assert "served 144 tokens over 144 iters" in lines
    assert any(ln.startswith("preemptions 12  swap ops 18  ")
               for ln in lines)
    assert sum(ln.startswith("conv ") for ln in lines) == 6


def test_train_lm_losses_match_reference_step_by_step():
    """Five steps of the example's loop; step i's loss against the
    reference's jitted ``train_step`` on the parameters the example held
    before step i (its first i steps run again from the same start) and
    step i's batch.  Parameters are compared step by step because AdamW
    amplifies a gradient's rounding into a 2 * lr move of the weight, so
    two trajectories part by more than the loss tolerance within a few
    steps."""
    jcfg = jax_smoke_config("qwen2-1.5b")
    cfg = get_smoke_config("qwen2-1.5b")
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(0))

    def start():
        return T.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")

    kw = dict(batch=8, seq=64, device="cpu", log_every=10 ** 6)
    _, losses = torch_train_lm.train(cfg, start(), steps=5, **kw)
    assert losses[-1] < losses[0]
    step = jax.jit(lambda p, o, b: jax_S.train_step(
        p, o, b, cfg=jcfg, lr=torch_train_lm.LR, remat=False))
    for i in range(5):
        before, _ = torch_train_lm.train(cfg, start(), steps=i, **kw)
        jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), before)
        batch = {k: jnp.asarray(v) for k, v in
                 torch_train_lm.make_batch(i, 8, 64).items()}
        _, _, jl = step(jp, jax_opt.adamw_init(jp), batch)
        np.testing.assert_allclose(losses[i], float(jl), rtol=LOSS_RTOL,
                                   err_msg=f"step {i}")


def test_train_lm_checkpoint_reads_in_the_reference(tmp_path, capsys):
    path = str(tmp_path / "ckpt.npz")
    torch_train_lm.main(["--device", "cpu", "--steps", "5",
                         "--checkpoint", path])
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("loss ") and \
        out[-1].endswith(f"checkpoint round-trip OK ({path})")
    like = jax_T.init_params(jax_smoke_config("qwen2-1.5b"),
                             jax.random.PRNGKey(1))
    restored = jax_ckpt.load_checkpoint(path, like)
    leaves = jax.tree_util.tree_flatten_with_path(restored)[0]
    with np.load(path) as saved:
        keys = ["/".join(str(getattr(k, "key", k)) for k in p)
                for p, _ in leaves]
        assert sorted(keys) == sorted(saved.files)
        for key, (_, leaf) in zip(keys, leaves):
            want = saved[key]
            got = np.asarray(leaf)
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_array_equal(got, want, err_msg=key)
    # and the port's own loader reads the same bytes under the same keys
    mine = ckpt.load_checkpoint(path, T.params_from_numpy(
        jax.tree.map(np.asarray, like), "cpu"))
    got = dict(ckpt.keyed_leaves(mine))
    assert sorted(got) == sorted(keys)
    for key, (_, leaf) in zip(keys, leaves):
        assert torch.equal(got[key], torch.from_numpy(np.array(leaf))), key
