// Run-coalesced block copy: src[:, s:s+l] -> dst[:, d:d+l] for each run.
//
// Replaces the Pallas TPU kernel repro/kernels/block_copy.py
// (_copy_runs_3d -> pallas_call, body _gather_run_kernel), which serves
// both halves of the staged swap plane: block_gather_runs (pool -> zeroed
// slab, before the one d2h transfer) and block_scatter_runs (slab -> pool,
// after the one h2d transfer).
//
// What bounds it on the card: HBM bytes, 2 x the bytes moved (each byte is
// read once and written once); it does no arithmetic.  So the design only
// keeps many 16-byte loads in flight: one CTA per (run, block-in-run) and
// each CTA streams the block's C = L * 2 (layer, k/v) plane rows, 8 KB each
// at qwen2-1.5b (bs 16 x Hkv 2 x D 128 bf16), as uint4 vectors, issuing
// kUnroll independent loads before their stores.
//
// Semantics kept from the TPU kernel: the grid spans (n_runs, run_blocks)
// and steps with j >= len do nothing, so zero-length pad runs (the pow2
// run-count padding of ops._pad_runs) copy nothing; the copy is in place on
// dst, whose untouched blocks keep their bytes; block indices are clamped
// into range as the TPU kernel's index maps clamp them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
copy_runs_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                 const int* __restrict__ src_starts,
                 const int* __restrict__ dst_starts,
                 const int* __restrict__ lens, int C, long long n_src,
                 long long n_dst, long long row_vec) {
  const int run = blockIdx.x;
  const int j = blockIdx.y;
  if (j >= lens[run]) return;
  long long s = (long long)src_starts[run] + j;
  long long d = (long long)dst_starts[run] + j;
  s = s < 0 ? 0 : (s >= n_src ? n_src - 1 : s);
  d = d < 0 ? 0 : (d >= n_dst ? n_dst - 1 : d);
  const long long sstride = n_src * row_vec;   // one (layer, k/v) plane
  const long long dstride = n_dst * row_vec;
  for (long long e = threadIdx.x; e < row_vec; e += kThreads) {
    const uint4* sp = src + s * row_vec + e;
    uint4* dp = dst + d * row_vec + e;
    int c = 0;
    for (; c + kUnroll <= C; c += kUnroll) {
      uint4 buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) buf[u] = sp[(c + u) * sstride];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) dp[(c + u) * dstride] = buf[u];
    }
    for (; c < C; ++c) dp[c * dstride] = sp[c * sstride];
  }
}

}  // namespace

// src (C, n_src, row_bytes) and dst (C, n_dst, row_bytes): contiguous,
// 16-byte aligned, row_bytes a multiple of 16.  src_starts / dst_starts /
// lens: int32 (n_runs,).  Launches on ``stream`` and returns the
// cudaGetLastError() code (0 = launched).
extern "C" int fs_copy_runs(const void* src, void* dst, const void* src_starts,
                            const void* dst_starts, const void* lens,
                            int n_runs, int run_blocks, int C, long long n_src,
                            long long n_dst, long long row_bytes,
                            void* stream) {
  if (n_runs <= 0 || run_blocks <= 0 || run_blocks > 65535 || C <= 0 ||
      n_src <= 0 || n_dst <= 0 || row_bytes <= 0 || row_bytes % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(n_runs, run_blocks);
  copy_runs_kernel<<<grid, kThreads, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst),
      static_cast<const int*>(src_starts), static_cast<const int*>(dst_starts),
      static_cast<const int*>(lens), C, n_src, n_dst, row_bytes / 16);
  return (int)cudaGetLastError();
}
