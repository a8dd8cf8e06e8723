// Causal (or full) flash attention over (B, H, T, D) with GQA pre-expanded,
// fp32 or bf16 in and out, fp32 softmax statistics and accumulators.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> pallas_call, body _kernel): q tiles attend k/v tiles
// with an online softmax, the running max m, the sum l and the (rows x D)
// accumulator kept on chip until one write of the output.
//
// What bounds it on the card: operations.  At qwen2-1.5b's prefill (T 2048,
// D 128) it does ~500 flops per byte it must read, above the H100's ~295
// flop/byte bf16 ridge.  This first version runs its products on the fp32
// pipes, not the tensor cores (wgmma is later work), so it is far from that
// bound; what it does is keep every operand it multiplies in shared memory
// and registers:
//   * one CTA per (q tile of kBQ rows, head, batch), 256 threads as 16 x 16;
//     each thread owns a 4 x 4 block of the (kBQ x kBK) score tile and, for
//     the P.V product, 4 rows x D/16 columns of the accumulator;
//   * Q (transposed), each K tile (transposed) and V tile are staged in
//     shared memory as fp32, so both products read float4s along
//     neighbouring threads with no bank conflicts;
//   * row statistics are reduced over the 16 threads that share a row with
//     warp shuffles; P goes through shared memory to the P.V product.
//
// Semantics kept from the TPU kernel: scale D^-0.5 applied to q.k; causal
// masking compares positions from index 0 of q and of k (col <= row, the
// top-left alignment, which differs from a bottom-right mask when T != S);
// masked scores are -1e30, m starts at -1e30, l is clamped at 1e-30 before
// the final division.  The TPU kernel walks every k tile; this one skips
// the tiles past a q tile's last row, which are fully masked: for them
// every p is exp(-1e30 - m) = 0 and alpha is 1, so skipping them leaves the
// result unchanged.  Q tiles are launched longest first (causal rows near
// the end walk the most tiles).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // keys per tile
constexpr int kPS = kBQ + 4;    // row stride of the transposed P tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows x D of `src` (row-major, rows >= n_valid read as 0) into `dst` as
// fp32, transposed: dst[d * ld + row].  Threads walk rows fastest, so the
// shared-memory writes of a warp land in 32 consecutive words.
template <typename T, int D>
__device__ __forceinline__ void load_transposed(const T* __restrict__ src,
                                                float* dst, int rows,
                                                int n_valid, int ld) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;
  for (int x = threadIdx.x; x < rows * CH; x += kThreads) {
    const int r = x % rows;
    const int c = x / rows;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < n_valid) {
      raw = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c * VEC);
    }
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[(c * VEC + e) * ld + r] = to_f32(vals[e]);
  }
}

// rows x D of `src` into `dst` as fp32, row-major (rows >= n_valid as 0).
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          float* dst, int rows, int n_valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;
  for (int x = threadIdx.x; x < rows * CH; x += kThreads) {
    const int r = x / CH;
    const int c = x % CH;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < n_valid) {
      raw = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c * VEC);
    }
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * D + c * VEC + e] = to_f32(vals[e]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int Tq,
             int S, int causal, float scale) {
  constexpr int DV = D / 64;   // float4 column groups per thread in P.V
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // D x kBQ
  float* kT = qT + D * kBQ;                      // D x kBK
  float* vs = kT + D * kBK;                      // kBK x D
  float* pT = vs + kBK * D;                      // kBK x kPS

  const int n_qt = (Tq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* kp = k + bh * S * D;
  const T* vp = v + bh * S * D;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_transposed<T, D>(q + (bh * Tq + q0) * D, qT, kBQ, Tq - q0, kBQ);

  float acc[4][DV][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DV; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
    }
  }

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's reads of kT / vs / pT are done
    load_transposed<T, D>(kp + (size_t)k0 * D, kT, kBK, S - k0, kBK);
    load_rows<T, D>(vp + (size_t)k0 * D, vs, kBK, S - k0);
    __syncthreads();

    // scores: s[i][j] = q[ty*4+i] . k[tx*4+j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * kBQ + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kT + d * kBK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
    }

    // online softmax per row, reduced over the 16 threads of the row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (col >= S) {
          x = -INFINITY;          // no such key: probability exactly 0
        } else if (causal && col > row) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DV; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pT + (tx * 4 + j) * kPS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc[i] += p[row i, key kk] * v[kk, columns c * 64 + tx * 4 + e]
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(pT + kk * kPS + ty * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const float4 b =
            *reinterpret_cast<const float4*>(vs + kk * D + c * 64 + tx * 4);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][c][e] = fmaf(pv[i], bv[e], acc[i][c][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* o = out + (bh * Tq + row) * D;
#pragma unroll
    for (int c = 0; c < DV; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) store(o + c * 64 + tx * 4 + e, acc[i][c][e] / li);
    }
  }
}

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * kBQ + (size_t)D * kBK +
                          (size_t)kBK * D + (size_t)kBK * kPS);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Tq, int S, int causal, float scale, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Tq, S, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Tq, D), k / v (B, H, S, D), out (B, H, Tq, D): contiguous,
// 16-byte aligned, all fp32 (bf16 = 0) or all bf16 (bf16 = 1); D 64 or 128.
// Launches on ``stream`` and returns the CUDA error code (0 = launched).
extern "C" int fs_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int B, int H, int Tq, int S,
                                  int D, int causal, int bf16, float scale,
                                  void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || S <= 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) {
    return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, out, B, H, Tq, S, causal,
                                            scale, s)
                : launch<float, 64>(q, k, v, out, B, H, Tq, S, causal, scale,
                                    s);
  }
  if (D == 128) {
    return bf16 ? launch<__nv_bfloat16, 128>(q, k, v, out, B, H, Tq, S,
                                             causal, scale, s)
                : launch<float, 128>(q, k, v, out, B, H, Tq, S, causal,
                                     scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
