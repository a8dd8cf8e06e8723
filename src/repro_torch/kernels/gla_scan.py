"""Chunked gated linear attention with a scalar per-step decay (the
Mamba2 / SSD scan): the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/gla_scan.py``.  Per (batch, head), over
chunks of ``chunk`` steps, with L the inclusive cumsum of logw inside the
chunk and S the (N, P) state carried from chunk to chunk:

    y      = (q * exp(L)) @ S + tril((q @ k^T) * exp(min(L_i - L_j, 0))) @ v
    S_next = exp(L_C) * S + (k * exp(L_C - L))^T @ v

all in fp32.  q, k: (B, H, T, N); v: (B, H, T, P); logw: (B, H, T), <= 0.
Returns y (B, H, T, P) in q's dtype and the final state (B, H, N, P) in
fp32.  On a CPU tensor the wrapper computes the plain version; on a CUDA
tensor it launches ``csrc/gla_scan.cu`` (fp32 or bf16; N, P and chunk
multiples of 4 whose tiles fit in shared memory) or raises.  The launch
(``launch_plan``): bf16 with N at most 128 and chunk at most 64 runs on
the tensor cores, one CTA of 16 warps per (batch, head) and slice of up to
64 columns of P; the rest on the fp32 pipes, one CTA per (batch, head) and
16 columns of P.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build, launches

# shared memory one CTA may use on an H100 (227 KB)
MAX_SMEM_BYTES = 232_448


def _check_shapes(q, k, v, logw, chunk: int):
    B, H, T, N = q.shape
    if k.shape != q.shape or v.shape[:3] != (B, H, T) \
            or logw.shape != (B, H, T):
        raise ValueError(f"gla_scan_scalar: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)} do not match")
    if chunk <= 0 or T % chunk:
        raise ValueError(f"gla_scan_scalar: T={T} % chunk={chunk}")


def gla_scan_scalar_plain(q, k, v, logw, *, chunk: int = 64):
    """Plain version: the chunked form, one chunk at a time over all
    (batch, head) pairs, as the TPU kernel walks its chunk axis."""
    _check_shapes(q, k, v, logw, chunk)
    B, H, T, N = q.shape
    P = v.shape[-1]
    S = torch.zeros((B, H, N, P), dtype=torch.float32, device=q.device)
    ys = []
    tril = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()
    for c0 in range(0, T, chunk):
        qc, kc, vc = (x[:, :, c0:c0 + chunk].float() for x in (q, k, v))
        L = torch.cumsum(logw[:, :, c0:c0 + chunk].float(), dim=-1)
        y = (qc * torch.exp(L)[..., None]) @ S
        A = qc @ kc.transpose(-1, -2)
        A = A * torch.exp(torch.clamp(L[..., :, None] - L[..., None, :],
                                      max=0.0))
        A = torch.where(tril, A, torch.zeros((), device=q.device))
        ys.append((y + A @ vc).to(q.dtype))
        L_tot = L[..., -1:]
        k_scaled = kc * torch.exp(L_tot - L)[..., None]
        S = torch.exp(L_tot)[..., None] * S + k_scaled.transpose(-1, -2) @ vc
    return torch.cat(ys, dim=2), S


MMA_MAX_N, MMA_MAX_CHUNK = 128, 64
FMA_P_SPLIT = 16             # P columns per CTA of the fp32-pipe kernel
_STAGES, _WARPS = 3, 16
_TERMS_A = _TERMS_S = _TERMS_W = 3


class Plan(NamedTuple):
    route: str               # "mma" (tensor cores) or "fma" (fp32 pipes)
    pt: int                  # P columns per CTA
    p_splits: int            # CTAs per (batch, head)
    smem: int                # shared bytes per CTA


def _align1k(n: int) -> int:
    return -(-n // 1024) * 1024


def _mma_smem(N: int, chunk: int, pt: int) -> int:
    """``mma_layout(N, C, pt).total`` of ``csrc/gla_scan.cu``."""
    n_pad = 16                                   # 16 times a power of two
    while n_pad < N:
        n_pad *= 2
    c_pad = -(-chunk // 16) * 16
    mt = c_pad // 16
    stage = _align1k(2 * _align1k(c_pad * n_pad * 2)
                     + _align1k(c_pad * pt * 2) + c_pad * 4)
    return (_STAGES * stage + 2 * _TERMS_S * pt * n_pad * 2
            + 2 * _TERMS_W * c_pad * pt * 2
            + 2 * mt * (mt + 1) // 2 * _TERMS_A * 512
            + _WARPS * c_pad * 4 + 2 * c_pad * 4 + _STAGES * 8 + 1024)


def launch_plan(N: int, P: int, chunk: int, bf16: bool) -> Plan:
    """The kernel launch for these shapes, from shapes alone: the route,
    the P slice of a CTA, the CTAs per (batch, head) and the shared memory
    a CTA needs (``mma_pt``, ``mma_layout`` and ``fma_smem_bytes`` in
    ``csrc/gla_scan.cu``)."""
    if bf16 and N <= MMA_MAX_N and chunk <= MMA_MAX_CHUNK:
        pt = 64
        while pt > 16 and (pt // 2 >= P
                           or _mma_smem(N, chunk, pt) > MAX_SMEM_BYTES):
            pt //= 2
        return Plan("mma", pt, -(-P // pt), _mma_smem(N, chunk, pt))
    pw = min(P, FMA_P_SPLIT)
    return Plan("fma", FMA_P_SPLIT, -(-P // FMA_P_SPLIT),
                4 * (chunk * N + N * (chunk + 4) + chunk * pw + chunk * chunk
                     + N * pw + 2 * chunk))


def _check_cuda_args(q, k, v, logw, chunk: int):
    if any(not t.is_cuda or t.device != q.device for t in (k, v, logw)):
        raise ValueError("gla_scan_scalar: all operands must be on one CUDA "
                         "device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("gla_scan_scalar: the CUDA kernel takes q, k, v all "
                        f"fp32 or all bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("gla_scan_scalar: q, k, v must be contiguous")
    N, P = q.shape[-1], v.shape[-1]
    if N % 4 or P % 4 or chunk % 4:
        raise ValueError(f"gla_scan_scalar: the CUDA kernel takes N {N}, P "
                         f"{P} and chunk {chunk} as multiples of 4")
    smem = launch_plan(N, P, chunk, q.dtype == torch.bfloat16).smem
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"gla_scan_scalar: N {N}, P {P}, chunk {chunk} need "
                         f"{smem} B of shared memory, more than "
                         f"{MAX_SMEM_BYTES}")


def _aligned(t):
    """``t``, or a copy of it where its data is not 16-byte aligned (the
    kernel copies 16-byte chunks)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def gla_scan_scalar(q, k, v, logw, *, chunk: int = 64):
    """q, k: (B, H, T, N); v: (B, H, T, P); logw: (B, H, T) scalar decay
    (<= 0).  Returns (y: (B, H, T, P), S: (B, H, N, P) fp32).

    CPU tensors take ``gla_scan_scalar_plain``; CUDA tensors launch the
    kernel on the current stream (and count it in
    ``gla_scan_scalar.launches``)."""
    _check_shapes(q, k, v, logw, chunk)
    launches.refuse_shapes_only("gla_scan_scalar", q, k, v, logw)
    if not q.is_cuda:
        return gla_scan_scalar_plain(q, k, v, logw, chunk=chunk)
    _check_cuda_args(q, k, v, logw, chunk)
    B, H, T, N = q.shape
    P = v.shape[-1]
    y = torch.empty((B, H, T, P), dtype=q.dtype, device=q.device)
    if 0 in (B, H, T, N, P):
        return y, torch.zeros((B, H, N, P), dtype=torch.float32,
                              device=q.device)
    S = torch.empty((B, H, N, P), dtype=torch.float32, device=q.device)
    q, k, v = (_aligned(t) for t in (q, k, v))
    lw = _aligned(logw.to(torch.float32).contiguous())
    lib = build.library("gla_scan")
    code = lib.fs_gla_scan_scalar(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        y.data_ptr(), S.data_ptr(), B * H, T, N, P, chunk,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(code, "gla_scan_scalar")
    launches.count(gla_scan_scalar)
    return y, S


gla_scan_scalar.launches = 0
