"""Multi-pod dry-run: trace one step of every (architecture x input shape)
on the production meshes and report per-device memory and the roofline.

Counterpart of ``repro/launch/dryrun.py``.  Where the reference lowers
and compiles each case for 512 forced host devices, the port lays the
case's params, optimizer state, batch and caches out as DTensors over
meta shards on a ``DeviceMesh`` of a fake process group
(``launch/mesh.py``) and runs the step once under a counting dispatch
mode (``roofline/analysis.py``): nothing is allocated on any device.
Its result keys are the reference's, read so:

  * ``argument_bytes_per_device`` / ``output_bytes_per_device``: the
    local shard bytes of the step's inputs / outputs (exact);
  * ``temp_bytes_per_device``: an estimate, the peak of the live local
    bytes the trace allocated, beyond the arguments and the outputs;
  * ``generated_code_bytes``: 0 (nothing is compiled);
  * ``t_lower_s``: seconds to build the case; ``t_compile_s``: seconds
    to trace the step.

``--serving`` drives the port's ``ServingEngine`` through its public API
(three requests, one aborted), on the card at full width by default,
with ``--device cpu`` at the reduced config.  ``--smoke`` takes the
reduced configs for the mesh cases and ``--mesh`` another mesh (e.g.
``2x2``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
      --out results/dryrun

Exit code != 0 if any requested case fails.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
import traceback

from repro_torch.configs import (INPUT_SHAPES, SHAPES_BY_NAME, InputShape,
                                 get_config, get_smoke_config, list_archs)

# the ROADMAP item that ports fslint (``repro/analysis/``), whose static
# pass ``--audit-jit`` needs
AUDIT_JIT_PENDING = ("--audit-jit needs fslint's static pass "
                     "(jit_budget, in the reference's repro/analysis/), which "
                     "the port does not have yet: ROADMAP.md queue 1 item 5, 'Static "
                     "analysis, analysis/ (ten files), and the dry-run's "
                     "--audit-jit'")


def _mesh_for(multi_pod: bool, sizes=None):
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    if sizes is None:
        return make_production_mesh(multi_pod=multi_pod)
    names = ("pod", "data", "model")[-len(sizes):]
    return make_mesh(sizes, names)


def _mesh_tag(multi_pod: bool, sizes=None) -> str:
    if sizes is not None:
        return "x".join(map(str, sizes))
    return "2x16x16" if multi_pod else "16x16"


def trace_case(case, mesh):
    """Run ``case``'s step once over its DTensors under a
    ``TraceCounter``; returns (outputs, counter, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.specs import local_tensors
    from repro_torch.roofline.analysis import TraceCounter, dtensor_trace
    counter = TraceCounter(mesh)
    counter.register_arguments(local_tensors(case["args"]))
    t0 = time.time()
    with dtensor_trace(), implicit_replication(), counter:
        out = case["fn"](*case["args"])
    return out, counter, time.time() - t0


def run_case(arch: str, shape_name: str, multi_pod: bool,
             want_roofline: bool = True, variant: str = "baseline",
             mesh_sizes=None, smoke: bool = False, shape=None) -> dict:
    """One mesh case.  ``mesh_sizes`` overrides the production mesh (the
    last axes of ("pod", "data", "model")), ``smoke`` takes the reduced
    config, ``shape`` an ``InputShape`` in place of ``shape_name``'s."""
    from repro_torch.launch import specs
    from repro_torch.roofline import analysis as roofline
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = shape if shape is not None else SHAPES_BY_NAME[shape_name]
    tag = _mesh_tag(multi_pod, mesh_sizes)
    ok, why = specs.supports_case(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "mesh": tag,
                "status": "skipped", "reason": why}
    mesh = _mesh_for(multi_pod, mesh_sizes)
    t0 = time.time()
    case = specs.build_case(cfg, shape, mesh, variant=variant)
    t_build = time.time() - t0
    out, counter, t_trace = trace_case(case, mesh)
    # the arguments the step reads (jit drops the others, and with them
    # their bytes: whisper's encoder in a decode step)
    args_b = sum(t.numel() * t.element_size()
                 for t in specs.local_tensors(case["args"])
                 if counter.argument_read(t))
    out_b = specs.local_bytes(out)
    # outputs the trace allocated (not arguments updated in place) are
    # live at its end; XLA counts them as outputs, not temps
    arg_storages = {t.untyped_storage()._cdata
                    for t in specs.local_tensors(case["args"])}
    new_out_b = sum(t.untyped_storage().nbytes()
                    for t in {t.untyped_storage()._cdata: t for t in
                              specs.local_tensors(out)}.values()
                    if t.untyped_storage()._cdata not in arg_storages)
    temp_b = max(counter.peak - new_out_b, 0)
    result = {
        "arch": arch, "shape": shape.name, "mesh": tag,
        "variant": variant,
        "status": "ok",
        "t_lower_s": round(t_build, 2),
        "t_compile_s": round(t_trace, 2),
        "memory": {
            "argument_bytes_per_device": args_b,
            "output_bytes_per_device": out_b,
            "temp_bytes_per_device": temp_b,
            "generated_code_bytes": 0,
        },
        "trace_ops": counter.ops,
        "fallbacks": dict(counter.fallbacks),
        "decomposed": dict(counter.decomposed),
    }
    if want_roofline:
        mf = roofline.model_flops_estimate(cfg, shape)
        af, ab = roofline.analytic_floors(cfg, shape, mesh.size)
        terms = roofline.analyze(counter, n_chips=mesh.size, model_flops=mf,
                                 analytic_flops_dev=af,
                                 analytic_bytes_dev=ab,
                                 bytes_per_chip_peak=float(
                                     args_b + out_b + temp_b))
        result["roofline"] = terms.as_dict()
    return result


def run_serving_case(arch: str, device: str = "cuda") -> dict:
    """Serving-path dry-run: the port's ``ServingEngine`` (bucketed
    prefill, the decode step's CUDA graphs, staged swaps) through the
    PUBLIC API for one arch — three requests added, stepped to
    completion, one aborted mid-flight — reporting the wall time, the
    decode step's graph variants and the kernels' launches.  On ``cuda``
    the published config at full width (random weights from seed 0); on
    ``cpu`` the reduced one."""
    import torch

    from repro_torch.core import EngineConfig, SamplingParams, ServingEngine
    from repro_torch.data.priority import PriorityTrace
    from repro_torch.data.sharegpt import synth_prompt_ids
    from repro_torch.kernels import block_copy as bc
    from repro_torch.kernels import launches
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer as T
    from repro_torch.models.paged import supports_paged

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is "
                         "false; pass --device cpu for the reduced model "
                         "on the CPU")
    cfg = get_config(arch) if device == "cuda" else get_smoke_config(arch)
    if not supports_paged(cfg):
        return {"arch": arch, "case": "serving", "status": "skipped",
                "reason": "no paged-pool support (needs uniform GQA)"}
    params = T.init_params(cfg, seed=0, device=device, serving=True)
    ec = EngineConfig(mode="real", num_gpu_blocks=64, num_cpu_blocks=128,
                      max_running=4, max_batch=4).with_policy("fastswitch")
    kernels = {"paged_attention": pa.paged_attention,
               "block_gather_runs": bc.block_gather_runs,
               "block_scatter_runs": bc.block_scatter_runs}
    launches.reset(*kernels.values())
    t0 = time.time()
    eng = ServingEngine(ec, trace=PriorityTrace("random", 1e-9, seed=0),
                        model_bundle={"cfg": cfg, "params": params})
    handles = [eng.add_request(synth_prompt_ids(i, 0, 12, cfg.vocab_size),
                               SamplingParams(max_tokens=6))
               for i in range(3)]
    it = 0
    while eng.has_work() and it < 2000:
        eng.step()
        if it == 2:
            eng.abort(handles[-1])
        it += 1
    variants = eng.runner.graph_cache_size()
    eng.shutdown()
    if device == "cuda":
        torch.cuda.synchronize()
    ok = not eng.has_work() and eng.metrics.total_tokens > 0
    return {"arch": arch, "case": "serving",
            "status": "ok" if ok else "FAIL",
            "device": device,
            "t_total_s": round(time.time() - t0, 2),
            "tokens": eng.metrics.total_tokens,
            "aborted": eng.metrics.aborted,
            "decode_graph_variants": variants,
            "kernel_launches": {k: w.launches for k, w in kernels.items()}}


def _resized(name: str, batch, seq):
    """``name``'s shape with its batch and sequence overridden where
    given (None where neither is)."""
    if batch is None and seq is None:
        return None
    s = SHAPES_BY_NAME[name]
    batch = s.global_batch if batch is None else batch
    seq = s.seq_len if seq is None else seq
    return InputShape(name, seq, batch, s.kind)


def _print_case(r, tag: str) -> None:
    """The reference's line for one mesh case."""
    if r["status"] == "ok":
        mem = r["memory"]
        rf = r.get("roofline", {})
        print(f"OK   {tag:60s} args={mem['argument_bytes_per_device']/2**30:6.2f}GiB "
              f"temp={mem['temp_bytes_per_device']/2**30:6.2f}GiB "
              f"dom={rf.get('dominant', '-'):10s} "
              f"lower={r['t_lower_s']}s compile={r['t_compile_s']}s",
              flush=True)
    elif r["status"] == "skipped":
        print(f"SKIP {tag:60s} {r['reason']}", flush=True)
    else:
        print(f"FAIL {tag:60s} {r['error']}", flush=True)


def _mesh_case(arch: str, shape: str, mp: bool, args, mesh_sizes) -> dict:
    """One mesh case by the CLI's flags, its line printed; a case that
    raises is a FAIL result."""
    tag = f"{arch} x {shape} x {_mesh_tag(mp, mesh_sizes)}"
    try:
        r = run_case(arch, shape, mp, want_roofline=not args.no_roofline,
                     variant=args.variant, mesh_sizes=mesh_sizes,
                     smoke=args.smoke,
                     shape=_resized(shape, args.batch, args.seq))
    except Exception as e:  # noqa: BLE001
        r = {"arch": arch, "shape": shape,
             "mesh": _mesh_tag(mp, mesh_sizes), "status": "FAIL",
             "error": f"{type(e).__name__}: {e}",
             "trace": traceback.format_exc()[-2000:]}
    _print_case(r, tag)
    return r


# the mesh cases that trace longest (the recurrent families' chunk loops
# over long sequences), started first by ``--jobs``
_SLOW_FIRST = ("zamba2-7b", "rwkv6-1.6b", "deepseek-v2-236b")


def _run_in_workers(cases, args) -> list:
    """The mesh cases split over ``args.jobs`` worker processes (each its
    own fake world), the slow ones dealt out first; each worker prints its
    lines as it goes.  A worker that dies fails its cases."""
    import shutil
    import subprocess
    import sys
    import tempfile
    order = sorted(cases, key=lambda c: (c[0] not in _SLOW_FIRST,
                                         c[1] != "prefill_32k"))
    groups = [order[i::args.jobs] for i in range(args.jobs)]
    groups = [g for g in groups if g]
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    flags = ["--variant", args.variant]
    for name in ("smoke", "no_roofline"):
        if getattr(args, name):
            flags.append("--" + name.replace("_", "-"))
    for name in ("mesh", "batch", "seq"):
        if getattr(args, name) is not None:
            flags += ["--" + name, str(getattr(args, name))]
    procs = []
    for i, g in enumerate(groups):
        out = os.path.join(tmp, f"{i}.json")
        procs.append((g, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--cases",
             json.dumps(g), "--out", out, *flags],
            stdout=subprocess.PIPE, text=True)))
    results = []
    for g, out, p in procs:
        text, _ = p.communicate()
        for line in text.splitlines():
            if not line.startswith("wrote "):
                print(line, flush=True)
        if os.path.exists(out):
            with open(out) as f:
                results += json.load(f)
            continue
        for arch, shape, mp in g:
            r = {"arch": arch, "shape": shape,
                 "mesh": _mesh_tag(mp, _parse_mesh(args.mesh)),
                 "status": "FAIL",
                 "error": f"worker exited {p.returncode} without results"}
            _print_case(r, f"{arch} x {shape} x {r['mesh']}")
            results.append(r)
    shutil.rmtree(tmp, ignore_errors=True)
    return results


def _parse_mesh(text):
    if text is None:
        return None
    sizes = tuple(int(x) for x in text.lower().split("x"))
    if not 2 <= len(sizes) <= 3:
        raise SystemExit(f"--mesh {text}: give DxM or PxDxM")
    return sizes


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="architecture id (repeatable)")
    ap.add_argument("--shape", action="append", default=None,
                    help="input shape name (repeatable)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="off")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    help="'+'-combinable: tp-params, kv-int8, moe-cap-shard")
    ap.add_argument("--serving", action="store_true",
                    help="also dry-run the online serving hot path "
                         "(ServingEngine add_request/step/abort)")
    ap.add_argument("--audit-jit", action="store_true",
                    help="not in the port yet: exits 2 (see ROADMAP.md)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="--serving's device: cuda serves the published "
                         "config at full width, cpu the reduced one")
    ap.add_argument("--smoke", action="store_true",
                    help="the mesh cases at the reduced configs")
    ap.add_argument("--mesh", default=None,
                    help="the mesh cases on this mesh (DxM or PxDxM) in "
                         "place of the production ones")
    ap.add_argument("--batch", type=int, default=None,
                    help="the global batch of every shape, in place of "
                         "its own")
    ap.add_argument("--seq", type=int, default=None,
                    help="the sequence length of every shape, in place "
                         "of its own")
    ap.add_argument("--jobs", type=int, default=1,
                    help="run the mesh cases in this many processes")
    ap.add_argument("--cases", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.audit_jit:
        print(AUDIT_JIT_PENDING, flush=True)
        return 2
    # DTensor warns on every multi-axis redistribution it plans
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    archs = args.arch or (list_archs() if args.all else ["qwen2-1.5b"])
    shapes = args.shape or ([s.name for s in INPUT_SHAPES] if args.all
                            else ["train_4k"])
    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    mesh_sizes = _parse_mesh(args.mesh)
    if mesh_sizes is not None:
        pods = [False]

    results = []
    n_fail = 0
    if args.serving:
        for arch in archs:
            r = run_serving_case(arch, args.device)
            results.append(r)
            if r["status"] == "FAIL":
                n_fail += 1
            print(f"{r['status']:4s} {arch} x serving "
                  + json.dumps({k: v for k, v in r.items()
                                if k not in ("arch", "case", "status")}),
                  flush=True)
    cases = [(arch, shape, mp) for arch in archs for shape in shapes
             for mp in pods]
    if args.cases is not None:
        cases = [tuple(c) for c in json.loads(args.cases)]
    if args.jobs > 1 and len(cases) > 1:
        res = _run_in_workers(cases, args)
    else:
        res = [_mesh_case(arch, shape, mp, args, mesh_sizes)
               for arch, shape, mp in cases]
    results += res
    n_fail += sum(r["status"] == "FAIL" for r in res)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
