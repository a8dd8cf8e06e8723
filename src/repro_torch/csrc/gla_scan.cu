// Chunked gated linear attention with a scalar per-step decay (the
// Mamba2 / SSD scan), fp32 or bf16 in, fp32 state and arithmetic.
//
// Replaces the Pallas TPU kernel repro/kernels/gla_scan.py
// (gla_scan_scalar -> pallas_call, body _kernel).  Per (batch, head), over
// chunks of C steps with L the inclusive cumsum of logw inside the chunk:
//
//     y      = (q * exp(L)) @ S  +  tril((q @ k^T) * exp(min(L_i - L_j, 0))) @ v
//     S_next = exp(L_C) * S + (k * exp(L_C - L))^T @ v
//
// What bounds it on the card: HBM bytes at the inputs' bf16 tensor-core
// rate (~64 flops per byte read at N = P = C = 64, under the H100's ~295
// flop/byte ridge).  This first version runs its products on the fp32
// pipes and, as the TPU kernel does, walks the chunks of one (batch, head)
// in order in one CTA, so it has only B * H CTAs and a chain of dependent
// chunk steps; what it does is keep every operand of a chunk on chip:
//   * one CTA per (batch, head), 256 threads; the N x P fp32 state S lives
//     in shared memory for the whole walk (16 KB at N = P = 64) and is
//     written once at the end;
//   * per chunk, q (row-major), k (transposed), v, the decayed score tile
//     A and the cumsum L are staged in shared memory as fp32; each thread
//     computes 4 neighbouring outputs of a product from one broadcast
//     scalar and one float4 per step of the inner sum;
//   * y is written straight from registers in the input dtype.
// The inter-chunk term is computed as exp(L_i) * (q @ S), equal to the TPU
// kernel's (q * exp(L)) @ S up to fp32 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void fma4(float a, const float4 b, float4& c) {
  c.x = fmaf(a, b.x, c.x);
  c.y = fmaf(a, b.y, c.y);
  c.z = fmaf(a, b.z, c.z);
  c.w = fmaf(a, b.w, c.w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gla_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ logw,
                T* __restrict__ y, float* __restrict__ s_out, int Tn, int N,
                int P, int C) {
  const int KS = C + 4;                  // row stride of the transposed k
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);   // C x N
  float* skT = sq + C * N;                       // N x KS
  float* sv = skT + N * KS;                      // C x P
  float* sA = sv + C * P;                        // C x C
  float* sS = sA + C * C;                        // N x P, the carried state
  float* sL = sS + N * P;                        // C, inclusive cumsum
  float* sW = sL + C;                            // C, exp(L_C - L_i)

  const size_t bh = blockIdx.x;
  const T* qb = q + bh * Tn * N;
  const T* kb = k + bh * Tn * N;
  const T* vb = v + bh * Tn * P;
  const float* lb = logw + bh * Tn;
  T* yb = y + bh * Tn * P;
  const int tid = threadIdx.x;
  const int C4 = C / 4;
  const int P4 = P / 4;

  for (int x = tid; x < N * P; x += kThreads) sS[x] = 0.f;

  for (int c0 = 0; c0 < Tn; c0 += C) {
    __syncthreads();   // the previous chunk's reads are done
    for (int x = tid; x < C * N; x += kThreads) {
      const int i = x / N;
      const int n = x % N;
      sq[x] = to_f32(qb[(size_t)c0 * N + x]);
      skT[n * KS + i] = to_f32(kb[(size_t)c0 * N + x]);
    }
    for (int x = tid; x < C * P; x += kThreads) {
      sv[x] = to_f32(vb[(size_t)c0 * P + x]);
    }
    for (int x = tid; x < C; x += kThreads) sL[x] = lb[c0 + x];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < C; ++i) {
        run += sL[i];
        sL[i] = run;
      }
    }
    __syncthreads();
    for (int x = tid; x < C; x += kThreads) sW[x] = expf(sL[C - 1] - sL[x]);

    // A[i][j] = (q_i . k_j) * exp(min(L_i - L_j, 0)) for j <= i, else 0
    for (int x = tid; x < C * C4; x += kThreads) {
      const int i = x / C4;
      const int j0 = (x % C4) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 <= i) {
        for (int n = 0; n < N; ++n) {
          fma4(sq[i * N + n],
               *reinterpret_cast<const float4*>(skT + n * KS + j0), a);
        }
      }
      const float av[4] = {a.x, a.y, a.z, a.w};
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        r[e] = j <= i ? av[e] * expf(fminf(sL[i] - sL[j], 0.f)) : 0.f;
      }
      *reinterpret_cast<float4*>(sA + i * C + j0) =
          make_float4(r[0], r[1], r[2], r[3]);
    }
    __syncthreads();

    // y_i = exp(L_i) * (q_i @ S) + sum_{j <= i} A[i][j] * v_j
    for (int x = tid; x < C * P4; x += kThreads) {
      const int i = x / P4;
      const int p0 = (x % P4) * 4;
      float4 inter = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int n = 0; n < N; ++n) {
        fma4(sq[i * N + n], *reinterpret_cast<const float4*>(sS + n * P + p0),
             inter);
      }
      const float dec = expf(sL[i]);
      float4 o = make_float4(dec * inter.x, dec * inter.y, dec * inter.z,
                             dec * inter.w);
      for (int j = 0; j <= i; ++j) {
        fma4(sA[i * C + j], *reinterpret_cast<const float4*>(sv + j * P + p0),
             o);
      }
      T* yp = yb + (size_t)(c0 + i) * P + p0;
      store(yp + 0, o.x);
      store(yp + 1, o.y);
      store(yp + 2, o.z);
      store(yp + 3, o.w);
    }
    __syncthreads();   // every read of the old S is done

    // S = exp(L_C) * S + sum_i (k_i * exp(L_C - L_i)) v_i^T
    const float decay = expf(sL[C - 1]);
    for (int x = tid; x < N * P4; x += kThreads) {
      const int n = x / P4;
      const int p0 = (x % P4) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = 0; i < C; ++i) {
        fma4(skT[n * KS + i] * sW[i],
             *reinterpret_cast<const float4*>(sv + i * P + p0), a);
      }
      float4* sp = reinterpret_cast<float4*>(sS + n * P + p0);
      const float4 old = *sp;
      *sp = make_float4(decay * old.x + a.x, decay * old.y + a.y,
                        decay * old.z + a.z, decay * old.w + a.w);
    }
  }
  __syncthreads();
  float* so = s_out + bh * N * P;
  for (int x = tid; x < N * P; x += kThreads) so[x] = sS[x];
}

// Shared memory one CTA needs (kernels/gla_scan.py::smem_bytes repeats it
// and refuses sizes above the card's 227 KB per block).
size_t smem_bytes(int N, int P, int C) {
  return sizeof(float) * ((size_t)C * N + (size_t)N * (C + 4) +
                          (size_t)C * P + (size_t)C * C + (size_t)N * P +
                          2 * (size_t)C);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* logw,
           void* y, void* s_out, int BH, int Tn, int N, int P, int C,
           cudaStream_t s) {
  const size_t bytes = smem_bytes(N, P, C);
  const cudaError_t err = cudaFuncSetAttribute(
      gla_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  gla_scan_kernel<T><<<BH, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<T*>(y), static_cast<float*>(s_out), Tn, N, P, C);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k (BH, T, N), v (BH, T, P), y (BH, T, P): contiguous, all fp32
// (bf16 = 0) or all bf16 (bf16 = 1); logw (BH, T) and s_out (BH, N, P)
// fp32.  N, P and C multiples of 4, T a multiple of C.  Launches on
// ``stream`` and returns the CUDA error code (0 = launched).
extern "C" int fs_gla_scan_scalar(const void* q, const void* k, const void* v,
                                  const void* logw, void* y, void* s_out,
                                  int BH, int Tn, int N, int P, int C,
                                  int bf16, void* stream) {
  if (BH <= 0 || Tn <= 0 || N <= 0 || P <= 0 || C <= 0 || N % 4 != 0 ||
      P % 4 != 0 || C % 4 != 0 || Tn % C != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, logw, y, s_out, BH, Tn, N, P,
                                      C, s)
              : launch<float>(q, k, v, logw, y, s_out, BH, Tn, N, P, C, s);
}
