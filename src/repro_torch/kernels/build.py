"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go
into ``build/kernels/`` at the repository root, named by a hash of the
source and flags, so an edited source is never served a stale build.  A
build writes a temporary file and renames it into place, so processes
that build the same library at once never load a half-written one.

Nothing is built at import: the first call that launches a kernel
builds what it needs, and ``build()`` builds several sources with one
``nvcc`` each, all started together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

SOURCES: Dict[str, str] = {
    "paged_attention": "paged_attention.cu",
    "block_copy": "block_copy.cu",
    "flash_attention": "flash_attention.cu",
    "gla_scan": "gla_scan.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float          # 0.0 when an earlier build was reused
    ptxas: List[str]        # the ``-Xptxas -v`` register / smem lines


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, BuildResult]:
    """Build the named sources (all by default), one ``nvcc`` process per
    source, started together.  Raises ``RuntimeError`` with the
    compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            results[name] = BuildResult(name, out, 0.0, [])
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    errors = []
    for name, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, out)
        ptxas = [ln.strip() for ln in log.splitlines()
                 if ("ptxas" in ln and "Used" in ln) or "spill" in ln]
        results[name] = BuildResult(name, out, seconds, ptxas)
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# each source's C entry points: name -> (argument types, result type)
SIGNATURES = {
    "paged_attention": {
        "fs_paged_attention_bf16": ([_P] * 7 + [_I] * 10 + [_F, _P], _I),
        "fs_paged_attention_f32": ([_P] * 7 + [_I] * 10 + [_F, _P], _I)},
    "block_copy": {
        "fs_copy_runs": ([_P] * 5 + [_I] * 3 + [_LL] * 3 + [_P, _P], _I),
        "fs_copy_blocks": ([_P] * 4 + [_I] + [_LL] * 3 + [_P, _P], _I)},
    "flash_attention": {
        "fs_flash_attention": ([_P] * 4 + [_I] * 7 + [_F, _P], _I)},
    "gla_scan": {
        "fs_gla_scan_scalar": ([_P] * 6 + [_I] * 6 + [_P], _I)},
}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed (once per
    process)."""
    lib = ctypes.CDLL(str(build([name])[name].path))
    for fn_name, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check_launch(code: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")
