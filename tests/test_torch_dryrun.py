"""repro_torch's dry-run and roofline tools against the JAX reference's
(CPU): the spec trees of every architecture on both production meshes,
the analytic floors, the CLI, and the ``constrain_*`` call sites, which
leave a forward unchanged where no activation context is set
(``test_torch_dryrun_bytes.py`` holds the argument bytes to the
reference's compiled ones).

The port's mesh cases live on a fake process group that is global to
its process, and the reference needs forced host devices before jax is
imported, so each of those runs in a subprocess of its own.
"""
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES_BY_NAME as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.launch import specs as jax_specs
from repro.models import sharding as jax_sharding
from repro.models import transformer as jax_T
from repro.roofline import analysis as jax_roofline
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke_config
from repro_torch.configs import list_archs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import attention, moe, sharding
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as roofline
from torch_threads import one_torch_thread  # noqa: E402,F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = (False, True)          # multi_pod


def _norm(entry):
    """A spec entry as PartitionSpec keeps it: a 1-tuple of axes is its
    axis."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _spec(s) -> tuple:
    return tuple(_norm(e) for e in s)


def _jax_specs(tree) -> dict:
    """{path: spec tuple} of a tree of NamedShardings / PartitionSpecs."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        keys = []
        for k in path:
            keys.append(str(getattr(k, "key", getattr(k, "name",
                                                      getattr(k, "idx", k)))))
        spec = leaf.spec if hasattr(leaf, "spec") else leaf
        out["/".join(keys)] = _spec(spec)
    return out


def _port_specs(tree, path="") -> dict:
    """{path: spec tuple} of a port spec tree (dicts, NamedTuples of spec
    tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, f"{path}/{k}" if path else k))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_port_specs(v, f"{path}/{k}" if path else k))
        return out
    return {path: _spec(tree)}


def _jax_mesh(multi_pod):
    m = production_mesh_shape(multi_pod=multi_pod)
    return AbstractMesh(m.sizes, m.axis_names)


def _jax_params_shape(arch):
    cfg = jax_config(arch)
    return cfg, jax.eval_shape(lambda k: jax_T.init_params(cfg, k),
                               jax.ShapeDtypeStruct((2,), jnp.uint32))


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_spec_trees_match_reference(arch, multi_pod):
    """param (baseline and replicate_data), train-batch, cache (bf16 and
    int8; the decode and the long-context layouts) and token specs,
    leaf for leaf, on a production mesh at published widths."""
    jm, pm = _jax_mesh(multi_pod), production_mesh_shape(multi_pod=multi_pod)
    jcfg, jparams = _jax_params_shape(arch)
    cfg = get_config(arch)
    params = T.init_params(cfg, device="meta")
    for rep in (False, True):
        want = _jax_specs(jax_sharding.param_shardings(jcfg, jm, jparams,
                                                       replicate_data=rep))
        got = _port_specs(sharding.param_shardings(cfg, pm, params,
                                                   replicate_data=rep))
        assert got == want, (arch, rep)
    shape = JAX_SHAPES["train_4k"]
    want = _jax_specs(jax_specs.train_batch_shardings(
        jcfg, jm, jax_specs.train_batch_specs(jcfg, shape)))
    got = _port_specs(specs.train_batch_shardings(
        cfg, pm, specs.train_batch_specs(cfg, shape)))
    assert got == want
    for name in ("decode_32k", "long_500k"):
        shape = JAX_SHAPES[name]
        for jdt, dt in ((None, None), (jnp.int8, torch.int8)):
            jc, _, _ = jax_specs.decode_input_specs(jcfg, shape,
                                                    kv_dtype=jdt)
            c, _, _ = specs.decode_input_specs(cfg, shape, kv_dtype=dt)
            assert ([tuple(x.shape) for x in jax.tree.leaves(jc)]
                    == [tuple(x.shape) for x in specs.local_tensors(c)])
            want = _jax_specs(jax_specs.cache_shardings(
                jcfg, jm, jc, shape.global_batch, shape.global_batch == 1))
            got = _port_specs(specs.cache_shardings(
                cfg, pm, c, shape.global_batch, shape.global_batch == 1))
            assert got == want, (arch, name, dt)
    for b in (1, 4, 16, 32, 128, 256, 512):
        assert (_spec(sharding.tokens_spec(pm, b))
                == _spec(jax_sharding.tokens_spec(jm, b)))
        for all_axes in (False, True):
            assert (_norm(specs.batch_spec(pm, b, all_axes))
                    == _norm(jax_specs.batch_spec(jm, b, all_axes)))


@pytest.mark.parametrize("arch", list_archs())
def test_floors_match_reference(arch):
    """analytic_floors and model_flops_estimate for every shape and both
    mesh sizes, to 1e-12 relative."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    for s in INPUT_SHAPES:
        js = JAX_SHAPES[s.name]
        np.testing.assert_allclose(roofline.model_flops_estimate(cfg, s),
                                   jax_roofline.model_flops_estimate(jcfg, js),
                                   rtol=1e-12)
        for n in (256, 512):
            np.testing.assert_allclose(
                roofline.analytic_floors(cfg, s, n),
                jax_roofline.analytic_floors(jcfg, js, n), rtol=1e-12)


def _env(**extra):
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1", **extra}
    return env


# the reference's OK line (repro/launch/dryrun.py:258-262)
OK_LINE = re.compile(r"^OK   .{60} args= *[\d.]+GiB temp= *[\d.]+GiB "
                     r"dom=(compute|memory|collective) *lower=[\d.]+s "
                     r"compile=[\d.]+s$")


def test_cli_smoke_mesh_and_audit_jit(tmp_path):
    """``python -m repro_torch.launch.dryrun`` over a 2 x 2 fake mesh at
    the reduced configs exits 0 with the reference's line formats and
    result keys; ``--audit-jit`` on the CPU exits 0 with its ok line
    (tests/test_torch_audit_jit.py holds its rows)."""
    out = tmp_path / "dr.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         "--mesh", "2x2", "--arch", "qwen2-1.5b", "--arch", "gemma3-12b",
         "--shape", "decode_32k", "--shape", "long_500k",
         "--variant", "kv-int8+tp-params", "--out", str(out)],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines()
             if ln[:4] in ("OK  ", "SKIP", "FAIL")]
    assert len(lines) == 4
    assert sum(bool(OK_LINE.match(ln)) for ln in lines) == 3, lines
    assert lines[1].startswith("SKIP qwen2-1.5b x long_500k x 2x2")
    res = json.loads(out.read_text())
    ok = [x for x in res if x["status"] == "ok"]
    assert set(ok[0]) >= {"arch", "shape", "mesh", "variant", "status",
                          "t_lower_s", "t_compile_s", "memory", "roofline"}
    assert set(ok[0]["memory"]) == {
        "argument_bytes_per_device", "output_bytes_per_device",
        "temp_bytes_per_device", "generated_code_bytes"}
    assert set(ok[0]["roofline"]) == {
        "flops_source", "bytes_source", "hlo_flops", "hlo_bytes", "flops",
        "hbm_bytes", "collective_bytes", "t_compute_s", "t_memory_s",
        "t_collective_s", "dominant", "model_flops", "useful_flops_ratio",
        "bytes_per_chip_peak", "collective_breakdown", "n_chips"}
    assert all(x["memory"]["generated_code_bytes"] == 0 for x in ok)
    a = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--audit-jit", "--device", "cpu"], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert a.returncode == 0, a.stdout[-2000:] + a.stderr[-2000:]
    assert any(ln.startswith("ok   qwen2-1.5b x jit-audit ")
               for ln in a.stdout.splitlines())


MESHES_SCRIPT = r"""
import torch.distributed as dist
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
assert not dist.is_initialized()
for m in (make_production_mesh(), make_production_mesh(multi_pod=True),
          make_host_mesh()):
    dm = m.device_mesh
    print(m.axis_names, tuple(dm.shape), dm.mesh_dim_names,
          int(dm.mesh.min()), int(dm.mesh.max()))
print(dist.get_world_size(), dist.get_backend())
"""


def test_production_meshes_over_one_fake_world():
    """The reference's mesh shapes and axis names over a fake world of 512
    ranks created by the first call (not at import); the 16 x 16 mesh
    takes ranks 0-255."""
    r = subprocess.run([sys.executable, "-c", MESHES_SCRIPT], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split("\n")[:4] == [
        "('data', 'model') (16, 16) ('data', 'model') 0 255",
        "('pod', 'data', 'model') (2, 16, 16) ('pod', 'data', 'model') 0 511",
        "('data', 'model') (1, 1) ('data', 'model') 0 0",
        "512 fake"]


def test_constrain_without_context_is_identity():
    """No activation context: every ``constrain_*`` returns its input
    object, and a forward with them replaced by the identity is
    byte-equal (MoE and MLA included)."""
    x = torch.randn(4, 8, 16)
    for fn in (sharding.constrain_batch, sharding.constrain_kv_seq,
               sharding.constrain_experts):
        assert fn(x) is x
    ident = lambda x, *a, **k: x                      # noqa: E731
    for arch in ("olmoe-1b-7b", "deepseek-v2-236b", "whisper-large-v3"):
        cfg = get_smoke_config(arch)
        params = T.init_params(cfg, seed=1, device="cpu")
        tok = torch.randint(0, cfg.vocab_size, (2, 12))
        extra = {}
        if cfg.encoder_decoder:
            extra["encoder_frames"] = torch.randn(2, cfg.n_encoder_tokens,
                                                  cfg.d_model)
        with torch.no_grad():
            a = T.forward_seq(params, cfg, tok, **extra)[0]
            saved = (T.constrain_batch, attention.constrain_kv_seq,
                     moe.constrain_experts)
            T.constrain_batch = attention.constrain_kv_seq = ident
            moe.constrain_experts = ident
            try:
                b = T.forward_seq(params, cfg, tok, **extra)[0]
            finally:
                (T.constrain_batch, attention.constrain_kv_seq,
                 moe.constrain_experts) = saved
        assert torch.equal(a, b), arch


def test_link_rates_by_axis():
    """NVLink where every group of an axis sits in one 8-GPU node, IB
    where a group crosses nodes (both axes of the 16 x 16 mesh)."""
    from repro_torch.launch.mesh import MeshShape
    m = production_mesh_shape()
    assert roofline.link_bw(m, "model") == roofline.IB_BW
    assert roofline.link_bw(m, "data") == roofline.IB_BW
    small = MeshShape(("data", "model"), (2, 4))
    assert roofline.link_bw(small, "model") == roofline.NVLINK_BW
    assert roofline.link_bw(small, "data") == roofline.NVLINK_BW
    assert roofline.link_bw(MeshShape(("data", "model"), (4, 4)),
                            "data") == roofline.IB_BW


def test_dryrun_is_shape_only():
    """The mesh cases build meta tensors only; ``run_case`` of a skipped
    shape says why as the reference does."""
    r = dryrun.run_case("qwen2-1.5b", "long_500k", False)
    assert r["status"] == "skipped" and "long_500k rule" in r["reason"]
    params = T.init_params(get_config("deepseek-v2-236b"), device="meta")
    assert all(t.is_meta for t in specs.local_tensors(params))


def test_kernel_wrappers_refuse_meta_tensors():
    """A kernel wrapper given meta tensors raises: it neither launches
    nor runs its plain version on shapes without data."""
    from repro_torch.kernels import block_copy as bc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gla_scan as gs
    from repro_torch.kernels import paged_attention as pa
    m = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt,  # noqa: E731
                                                  device="meta")
    i32 = lambda *s: m(*s, dt=torch.int32)                      # noqa: E731
    calls = [
        lambda: pa.paged_attention(m(2, 4, 64), m(8, 16, 2, 64),
                                   m(8, 16, 2, 64), i32(2, 4), i32(2),
                                   0.125),
        lambda: bc.block_gather_runs(m(4, 8, 32), m(4, 2, 32), i32(1),
                                     i32(1), i32(1), 1),
        lambda: bc.block_scatter_runs(m(4, 2, 32), m(4, 8, 32), i32(1),
                                      i32(1), i32(1), 1),
        lambda: bc.block_copy(m(8, 32), m(8, 32), i32(1), i32(1)),
        lambda: bc.block_copy_grouped(m(8, 32), m(8, 32), i32(1), i32(1),
                                      i32(1), 1),
        lambda: fa.flash_attention(m(1, 2, 128, 64), m(1, 2, 128, 64),
                                   m(1, 2, 128, 64)),
        lambda: gs.gla_scan_scalar(m(1, 2, 64, 16), m(1, 2, 64, 16),
                                   m(1, 2, 64, 16),
                                   m(1, 2, 64, dt=torch.float32)),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="meta or fake"):
            call()
