"""repro_torch's dry-run argument bytes against the JAX reference's
compiled ``argument_size_in_bytes`` (CPU), on 15 smoke cases.

The port's mesh cases live on a fake process group that is global to
its process, and the reference needs forced host devices before jax is
imported, so each side runs in subprocesses of its own.
"""
import json
import subprocess
import sys

from test_torch_dryrun import _env
from torch_threads import one_torch_thread  # noqa: E402,F401

# the reference's compiled per-device argument bytes, on a 2 x 2 mesh of
# Auto axes over 4 forced host devices (jax.make_mesh's Explicit axes fail
# its own CLI under this jax)
REFERENCE_ARGUMENT_BYTES = r"""
import json, sys
import jax, numpy as np
from repro.configs import get_smoke_config
from repro.configs.base import InputShape
from repro.launch.specs import build_case
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
out = {}
for arch, kind in json.loads(sys.argv[1]):
    case = build_case(get_smoke_config(arch), InputShape("s", 64, 4, kind),
                      mesh)
    with mesh:
        jitted = jax.jit(case["fn"], in_shardings=case["in_shardings"],
                         out_shardings=case.get("out_shardings"),
                         donate_argnums=case.get("donate_argnums", ()))
        compiled = jitted.lower(*case["args"]).compile()
    out[f"{arch}/{kind}"] = int(
        compiled.memory_analysis().argument_size_in_bytes)
print(json.dumps(out))
"""

PORT_ARGUMENT_BYTES = r"""
import json, sys
from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import run_case
out = {}
for arch, kind in json.loads(sys.argv[1]):
    r = run_case(arch, "s", False, want_roofline=False, mesh_sizes=(2, 2),
                 smoke=True, shape=InputShape("s", 64, 4, kind))
    out[f"{arch}/{kind}"] = r["memory"]["argument_bytes_per_device"]
print(json.dumps(out))
"""

ARG_CASES = [(a, k) for a in ("qwen2-1.5b", "olmoe-1b-7b", "zamba2-7b",
                              "deepseek-v2-236b", "whisper-large-v3")
             for k in ("train", "prefill", "decode")]


def test_argument_bytes_match_reference_compiled():
    """The port's per-device argument bytes equal the reference's compiled
    ``argument_size_in_bytes`` exactly, on 15 smoke cases (B 4 x S 64).
    ``jit`` drops the arguments a step does not read (whisper's encoder
    in its decode step, its unused ``lm_head``), and so does the port's
    count.  The reference compiles in three processes at once."""
    ref_env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [subprocess.Popen([sys.executable, "-c", script,
                               json.dumps(cases)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for script, cases, env in (
                 *((REFERENCE_ARGUMENT_BYTES, ARG_CASES[i::3], ref_env)
                   for i in range(3)),
                 (PORT_ARGUMENT_BYTES, ARG_CASES, _env()))]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert results[3] == {**results[0], **results[1], **results[2]}


