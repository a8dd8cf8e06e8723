// Block copies over KV pools, in place on dst.  Two entry points:
//
//   fs_copy_runs    runs src[:, s:s+l] -> dst[:, d:d+l] over (C, nb, row)
//                   views.  Replaces the Pallas TPU kernels
//                   repro/kernels/block_copy.py _copy_runs_3d (body
//                   _gather_run_kernel; the staged swap plane's
//                   block_gather_runs and block_scatter_runs) and, as its
//                   C = 1 case, block_copy_grouped (body _copy_run_kernel).
//   fs_copy_blocks  per-block pairs dst[dst_blocks[i]] = src[src_blocks[i]]
//                   over (nb, row) pools.  Replaces repro/kernels/
//                   block_copy.py block_copy (body _copy_kernel), the vLLM
//                   per-block data plane FastSwitch measures itself against.
//
// What bounds them on the card: HBM bytes, 2 x the bytes moved (each byte is
// read once and written once); they do no arithmetic.  So the designs only
// keep many wide loads in flight: one CTA per (run, block-in-run) or per
// index pair, neighbouring threads on neighbouring addresses, kUnroll
// independent loads before their stores.  A row is moved in the widest unit
// (16, 8, 4, 2 or 1 bytes) that divides the row size and both base
// addresses, so any row size works and 16-byte rows take uint4 loads.
//
// Semantics kept from the TPU kernels:
//   * the runs grid spans (n_runs, run_blocks) and steps with j >= len do
//     nothing, so zero-length pad runs copy nothing; the copy is in place on
//     dst, whose untouched blocks keep their bytes (the aliased output);
//   * a block index is the TPU index map's: start + j in int32 arithmetic, a
//     negative index counts from the end of the pool, and the result is
//     clamped into [0, n) -- never a read or write outside the pool;
//   * where several grid steps name one destination block (overlapping
//     runs, or a run past the end of a pool, whose last steps clamp onto
//     the pool's last block), the TPU's sequential grid leaves the last
//     step's bytes.  A CUDA grid has no order, so a first pass records in
//     a `winner` array (one int per destination block), by atomicMax, the
//     last step that names each block, and only that step copies.  Every
//     copy takes this pass: a memset and a marking launch of one thread
//     per grid step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

// The TPU index map's block for grid step j of a run starting at `start`.
__device__ __forceinline__ long long block_index(int start, int j,
                                                 long long n) {
  long long i = (int)((unsigned)start + (unsigned)j);   // int32, wrapping
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// One CTA moves one row of n vectors, kUnroll loads in flight per thread.
template <typename V>
__device__ __forceinline__ void copy_row(const V* __restrict__ s,
                                         V* __restrict__ d, long long n) {
  for (long long base = threadIdx.x; base < n;
       base += (long long)kThreads * kUnroll) {
    V buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + (long long)u * kThreads;
      if (e < n) buf[u] = s[e];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + (long long)u * kThreads;
      if (e < n) d[e] = buf[u];
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
copy_runs_kernel(const V* __restrict__ src, V* __restrict__ dst,
                 const int* __restrict__ src_starts,
                 const int* __restrict__ dst_starts,
                 const int* __restrict__ lens, int C, long long n_src,
                 long long n_dst, long long row_vec, int run_blocks,
                 const int* __restrict__ winner) {
  const int run = blockIdx.x;
  const int j = blockIdx.y;
  if (j >= lens[run]) return;
  const long long s = block_index(src_starts[run], j, n_src);
  const long long d = block_index(dst_starts[run], j, n_dst);
  if (winner[d] != run * run_blocks + j) return;
  if (C == 1) {
    copy_row(src + s * row_vec, dst + d * row_vec, row_vec);
    return;
  }
  const long long sstride = n_src * row_vec;   // one (layer, k/v) plane
  const long long dstride = n_dst * row_vec;
  for (long long e = threadIdx.x; e < row_vec; e += kThreads) {
    const V* sp = src + s * row_vec + e;
    V* dp = dst + d * row_vec + e;
    int c = 0;
    for (; c + kUnroll <= C; c += kUnroll) {
      V buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) buf[u] = sp[(c + u) * sstride];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) dp[(c + u) * dstride] = buf[u];
    }
    for (; c < C; ++c) dp[c * dstride] = sp[c * sstride];
  }
}

// winner[d] = the last grid step (run * run_blocks + j) that writes block d.
__global__ void mark_runs_kernel(const int* __restrict__ dst_starts,
                                 const int* __restrict__ lens, int n_steps,
                                 int run_blocks, long long n_dst,
                                 int* __restrict__ winner) {
  const int step = blockIdx.x * blockDim.x + threadIdx.x;
  if (step >= n_steps) return;
  const int run = step / run_blocks;
  const int j = step % run_blocks;
  if (j < lens[run]) {
    atomicMax(winner + block_index(dst_starts[run], j, n_dst), step);
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
copy_blocks_kernel(const V* __restrict__ src, V* __restrict__ dst,
                   const int* __restrict__ src_blocks,
                   const int* __restrict__ dst_blocks, long long n_src,
                   long long n_dst, long long row_vec,
                   const int* __restrict__ winner) {
  const int i = blockIdx.x;
  const long long d = block_index(dst_blocks[i], 0, n_dst);
  if (winner[d] != i) return;
  const long long s = block_index(src_blocks[i], 0, n_src);
  copy_row(src + s * row_vec, dst + d * row_vec, row_vec);
}

__global__ void mark_blocks_kernel(const int* __restrict__ dst_blocks, int n,
                                   long long n_dst, int* __restrict__ winner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) atomicMax(winner + block_index(dst_blocks[i], 0, n_dst), i);
}

// The widest power-of-two unit (<= 16 bytes) dividing the row size and
// both base addresses.
int unit_bytes(long long row_bytes, const void* a, const void* b) {
  const unsigned long long bits = (unsigned long long)row_bytes |
                                  (unsigned long long)(uintptr_t)a |
                                  (unsigned long long)(uintptr_t)b;
  int w = 16;
  while (w > 1 && bits % w != 0) w >>= 1;
  return w;
}

template <typename V>
void launch_runs(const void* src, void* dst, const int* src_starts,
                 const int* dst_starts, const int* lens, int n_runs,
                 int run_blocks, int C, long long n_src, long long n_dst,
                 long long row_bytes, const int* winner, cudaStream_t s) {
  const dim3 grid(n_runs, run_blocks);
  copy_runs_kernel<V><<<grid, kThreads, 0, s>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), src_starts,
      dst_starts, lens, C, n_src, n_dst, row_bytes / (long long)sizeof(V),
      run_blocks, winner);
}

template <typename V>
void launch_blocks(const void* src, void* dst, const int* src_blocks,
                   const int* dst_blocks, int n, long long n_src,
                   long long n_dst, long long row_bytes, const int* winner,
                   cudaStream_t s) {
  copy_blocks_kernel<V><<<n, kThreads, 0, s>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), src_blocks,
      dst_blocks, n_src, n_dst, row_bytes / (long long)sizeof(V), winner);
}

// Clear `winner` to -1 (all bytes 0xFF) on the stream.
int clear_winner(int* winner, long long n_dst, cudaStream_t s) {
  return (int)cudaMemsetAsync(winner, 0xFF, (size_t)n_dst * sizeof(int), s);
}

}  // namespace

// src (C, n_src, row_bytes) and dst (C, n_dst, row_bytes): contiguous, any
// row size.  src_starts / dst_starts / lens: int32 (n_runs,).  winner:
// int32 scratch of n_dst entries (required) that resolves destinations
// named by several steps as the TPU's sequential grid does.  Launches on
// ``stream`` and returns the CUDA error code (0 = launched).
extern "C" int fs_copy_runs(const void* src, void* dst, const void* src_starts,
                            const void* dst_starts, const void* lens,
                            int n_runs, int run_blocks, int C, long long n_src,
                            long long n_dst, long long row_bytes,
                            void* winner, void* stream) {
  if (n_runs <= 0 || run_blocks <= 0 || run_blocks > 65535 || C <= 0 ||
      n_src <= 0 || n_dst <= 0 || row_bytes <= 0 || winner == nullptr ||
      (long long)n_runs * run_blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* ss = static_cast<const int*>(src_starts);
  const auto* ds = static_cast<const int*>(dst_starts);
  const auto* ls = static_cast<const int*>(lens);
  auto* win = static_cast<int*>(winner);
  const int err = clear_winner(win, n_dst, s);
  if (err != 0) return err;
  const int n_steps = n_runs * run_blocks;
  mark_runs_kernel<<<(n_steps + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      ds, ls, n_steps, run_blocks, n_dst, win);
  switch (unit_bytes(row_bytes, src, dst)) {
    case 16: launch_runs<uint4>(src, dst, ss, ds, ls, n_runs, run_blocks, C,
                                n_src, n_dst, row_bytes, win, s); break;
    case 8: launch_runs<uint2>(src, dst, ss, ds, ls, n_runs, run_blocks, C,
                               n_src, n_dst, row_bytes, win, s); break;
    case 4: launch_runs<unsigned>(src, dst, ss, ds, ls, n_runs, run_blocks,
                                  C, n_src, n_dst, row_bytes, win, s); break;
    case 2: launch_runs<unsigned short>(src, dst, ss, ds, ls, n_runs,
                                        run_blocks, C, n_src, n_dst,
                                        row_bytes, win, s); break;
    default: launch_runs<unsigned char>(src, dst, ss, ds, ls, n_runs,
                                        run_blocks, C, n_src, n_dst,
                                        row_bytes, win, s); break;
  }
  return (int)cudaGetLastError();
}

// src (n_src, row_bytes) and dst (n_dst, row_bytes): contiguous, any row
// size.  src_blocks / dst_blocks: int32 (n,).  winner: int32 scratch of
// n_dst entries (required).  Launches on ``stream`` and returns the CUDA
// error code (0 = launched).
extern "C" int fs_copy_blocks(const void* src, void* dst,
                              const void* src_blocks, const void* dst_blocks,
                              int n, long long n_src, long long n_dst,
                              long long row_bytes, void* winner,
                              void* stream) {
  if (n <= 0 || n_src <= 0 || n_dst <= 0 || row_bytes <= 0 ||
      winner == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* sb = static_cast<const int*>(src_blocks);
  const auto* db = static_cast<const int*>(dst_blocks);
  auto* win = static_cast<int*>(winner);
  const int err = clear_winner(win, n_dst, s);
  if (err != 0) return err;
  mark_blocks_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      db, n, n_dst, win);
  switch (unit_bytes(row_bytes, src, dst)) {
    case 16: launch_blocks<uint4>(src, dst, sb, db, n, n_src, n_dst,
                                  row_bytes, win, s); break;
    case 8: launch_blocks<uint2>(src, dst, sb, db, n, n_src, n_dst,
                                 row_bytes, win, s); break;
    case 4: launch_blocks<unsigned>(src, dst, sb, db, n, n_src, n_dst,
                                    row_bytes, win, s); break;
    case 2: launch_blocks<unsigned short>(src, dst, sb, db, n, n_src, n_dst,
                                          row_bytes, win, s); break;
    default: launch_blocks<unsigned char>(src, dst, sb, db, n, n_src, n_dst,
                                          row_bytes, win, s); break;
  }
  return (int)cudaGetLastError();
}
