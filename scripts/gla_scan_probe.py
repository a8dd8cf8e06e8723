#!/usr/bin/env python3
"""Where the bf16 SSD-scan kernel spends its time, on one NVIDIA GPU.

    python3 scripts/gla_scan_probe.py      # from the root of a checkout

Builds variants of ``src/repro_torch/csrc/gla_scan.cu`` (text edits of
the source, compiled by ``nvcc`` into ``build/gla_probe/``, each bound by
ctypes like the port's own build) and prints one JSON line each:

  * ``variant``: the device time (``chip_smoke.device_ms``, cold L2) at
    zamba2-7b's shape (B 1, H 112, T 4096, N = P = chunk = 64, bf16) of
    the kernel as it is (``base``) and with one part changed or removed:
    one bf16 term for A, S and V_w (``terms1``), two for A and S
    (``terms_a2s2``), the copies of chunks past the second left out
    (``no_copies``), the y products left out (``no_y``), the state update
    left out (``no_state``), the next chunk's A and V_w left unmade
    (``no_prep``).  Variants that change the arithmetic report
    their error against the plain version instead of passing a gate.
  * ``phases``: clock64 cycles a chunk step spends in each phase, per
    warp of the first two CTAs, at H 112 and H 33.  The clock reads are
    not ordered with the barriers, so a warp's wait at a barrier may land
    in the phase before or after it.
  * ``heads``: the base kernel's device time at 33 to 264 heads (one CTA
    a head), which shows the waves.

Imports nothing of JAX.  The text edits name lines of the source; if the
source changes, the script stops with the line it could not find.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PHASES = ["wait+barrier", "copies", "y or state", "prep of the next"]
VARIANTS = {
    "base": [],
    "terms1": [("kTermsA = 3", "kTermsA = 1"), ("kTermsS = 3", "kTermsS = 1"),
               ("kTermsW = 3", "kTermsW = 1")],
    "terms_a2s2": [("kTermsA = 3", "kTermsA = 2"),
                   ("kTermsS = 3", "kTermsS = 2")],
    "no_copies": [("    wait_chunk(c + 1, false);",
                   "    if (c + 1 < kStages) wait_chunk(c + 1, false);"),
                  ("    load(c + 2);       // into the stage chunk c - 1 used",
                   "    if (c + 2 < kStages) load(c + 2);")],
    "no_y": [("        const int nat = u / SP;\n",
              "        if (u >= 0) continue;\n"
              "        const int nat = u / SP;\n")],
    "no_state": [("        float part[2][2][4];\n",
                  "        if (u >= 0) continue;\n"
                  "        float part[2][2][4];\n")],
    "no_prep": [("    if (state_warp && c + 1 < n_chunks) "
                 "l_next = prep(c + 1);",
                 "    if (state_warp && c + 1 < kStages - 1) "
                 "l_next = prep(c + 1);")],
    "phases": [
        ("template <int NK>\n__global__",
         "__device__ unsigned long long g_prof[32][8];\n"
         "template <int NK>\n__global__"),
        ("  load(0);\n  load(1);\n",
         "  unsigned long long tp[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
         "  long long t_last = 0;\n"
         "#define PROF(i) { const long long t_ = clock64(); "
         "tp[i] += t_ - t_last; t_last = t_; }\n"
         "  load(0);\n  load(1);\n"),
        ("    wait_chunk(c + 1, false);\n    __syncthreads();   // chunk c + 1 "
         "landed",
         "    if (c == 0) t_last = clock64();\n"
         "    wait_chunk(c + 1, false);\n    __syncthreads();   // chunk c + 1 "
         "landed"),
        ("    load(c + 2);       // into the stage chunk c - 1 used\n",
         "    PROF(0)\n    load(c + 2);       // into the stage chunk c - 1 "
         "used\n    PROF(1)\n"),
        ("    if (state_warp && c + 1 < n_chunks) l_next = prep(c + 1);",
         "    PROF(2)\n"
         "    if (state_warp && c + 1 < n_chunks) l_next = prep(c + 1);\n"
         "    PROF(3)"),
        ("\n  // the final state: S[n][p] = S^T[p][n]\n",
         "\n  if (lane == 0 && blockIdx.x < 2) {\n"
         "    for (int i = 0; i < 8; ++i) "
         "g_prof[blockIdx.x * 16 + warp][i] = tp[i];\n  }\n"
         "  // the final state: S[n][p] = S^T[p][n]\n"),
        ('extern "C" int fs_gla_scan_scalar(',
         'extern "C" int fs_read_prof(void* h) {\n'
         "  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n}\n"
         'extern "C" int fs_gla_scan_scalar('),
    ],
}


def build_variants(out: Path) -> dict:
    """{variant: bound ``fs_gla_scan_scalar``}, one nvcc each, together."""
    from repro_torch.kernels import build
    src = (build.CSRC / build.SOURCES["gla_scan"]).read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: line not found in gla_scan.cu: "
                                 f"{old!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
        fn = libs[name].fs_gla_scan_scalar
        fn.argtypes, fn.restype = build.SIGNATURES["gla_scan"][
            "fs_gla_scan_scalar"]
    return libs


def launcher(lib, case):
    import torch
    q, k, v, lw = case
    B, H, T, N = q.shape
    P = v.shape[-1]
    y = torch.empty((B, H, T, P), dtype=q.dtype, device=q.device)
    s = torch.empty((B, H, N, P), dtype=torch.float32, device=q.device)

    def run():
        code = lib.fs_gla_scan_scalar(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            y.data_ptr(), s.data_ptr(), B * H, T, N, P, 64, 1,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed with CUDA error {code}")
        return y, s
    return run


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels import gla_scan as gla
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    libs = build_variants(ROOT / "build" / "gla_probe")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    case = chip_smoke.gla_case(dev, seed=3)
    want = gla.gla_scan_scalar_plain(*case, chunk=64)
    for name, lib in libs.items():
        run = launcher(lib, case)
        y, s = run()
        torch.cuda.synchronize()
        try:
            err = list(chip_smoke.gla_errors(y, s, *want))
        except AssertionError as exc:
            err = str(exc)
        print(json.dumps({"variant": name, "device_ms":
                          chip_smoke.device_ms(run, flush=flush),
                          "errors": err}), flush=True)
    for H in (112, 33):
        launcher(libs["phases"], chip_smoke.gla_case(dev, seed=3, H=H))()
        torch.cuda.synchronize()
        buf = np.zeros((32, 8), np.uint64)
        if libs["phases"].fs_read_prof(ctypes.c_void_p(buf.ctypes.data)):
            raise RuntimeError("reading the phase clocks failed")
        n_chunks = 4096 // 64
        print(json.dumps({
            "phases": PHASES, "heads": H,
            "cycles_per_chunk": {f"cta{r // 16}_warp{r % 16}":
                                 [int(buf[r][i]) // n_chunks
                                  for i in range(len(PHASES))]
                                 for r in range(32)}}), flush=True)
    print(json.dumps({"heads": {H: chip_smoke.device_ms(
        launcher(libs["base"], chip_smoke.gla_case(dev, seed=3, H=H)),
        flush=flush) for H in (33, 66, 112, 132, 264)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
