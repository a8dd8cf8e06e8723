// Causal (or full) flash attention over (B, H, T, D) with GQA pre-expanded,
// fp32 or bf16 in and out, fp32 softmax statistics and accumulators.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> pallas_call, body _kernel): q tiles attend k/v tiles
// with an online softmax, the running max m, the sum l and the (rows x D)
// accumulator kept on chip until one write of the output.
//
// What bounds it on the card: operations.  At qwen2-1.5b's prefill (B 1,
// 12 heads, T 2048, D 128, causal) the visible (row, key) pairs need 12.9
// GFLOP against 25.2 MB of q, k, v and output, ~500 flops per byte, above
// the H100's ~295 flop/byte bf16 ridge: 0.0130 ms at 989 TFLOP/s.  At B 8 x
// T 512 the bytes bound instead (0.0150 ms at 3.35 TB/s).  (Published H100
// SXM peaks at its 700 W limit; chip_smoke.py computes both bounds.)
//
// bf16 route (flash_mma_kernel): both products on the tensor cores.
//   * One CTA per (64-row q tile, head, batch), 4 warps of 16 query rows.
//     The grid runs q tiles longest first across every head and batch
//     (causal rows near the end walk the most key tiles).
//   * Q is copied once into shared memory, then by ldmatrix into m16n8k16
//     A fragments that stay in registers for the whole key walk.
//   * K and V tiles (64 keys x D) go into a ring of kStages shared-memory
//     stages by 16-byte cp.async.cg copies; a tile's copies start
//     before the MMAs of the tile before it.  Rows of D bf16 (128 or 256
//     bytes) hold 16-byte chunks XOR-swizzled by (row & 7), so the 8 rows
//     an ldmatrix phase reads fall in 8 different bank groups.  Keys past S
//     are zero-filled by cp.async's src-size operand and masked.
//   * S = Q.K^T by mma.sync.m16n8k16.row.col (bf16 in, fp32 accumulate),
//     K straight from its row-major tile by ldmatrix (a K row is a B
//     column); O += P.V with V by ldmatrix.trans.  The S accumulator's
//     register layout is P's A-fragment layout (two n8 tiles make one k16
//     fragment), so P never goes through shared memory.
//   * Split P.  Rounding P to one bf16 before P.V, as the usual
//     FlashAttention-2 design does, costs a relative 2^-9 per weight, and
//     on chip_smoke's prefill inputs the output then misses the one-ulp
//     gate (1e-3 + 2^-7|ref|; tests/test_torch_chip_smoke.py shows it on
//     the CPU).  So each p is split into hi = bf16(p) and lo = bf16(p -
//     hi), and two MMAs run against each V fragment: hi + lo carries ~16
//     bits of p, 1.5x the MMA work of one product pair, still on the
//     tensor cores.  l is summed from the fp32 p.
//   * Online softmax in registers: a thread holds two rows of each m16n8
//     fragment; the row max reduces over the thread's quad by
//     __shfl_xor_sync (1, 2) every tile, the partial row sums once at the
//     end.  O is rescaled by alpha once per key tile.
//   * Causal: key tiles wholly past a q tile's last row are skipped (exact:
//     each of their p is exp(-1e30 - m) = 0 and alpha is 1); only tiles
//     that cross the diagonal or the S edge apply the mask.
//   * Epilogue: O / max(l, 1e-30), rounded to bf16 once, staged through
//     the Q tile's shared memory and written as 16-byte row chunks.
// Next for this kernel: wgmma (Hopper's only way to the full tensor-core
// rate; mma.sync reaches a part of it) fed by TMA stages from a producer
// warp, and a grid that evens out the causal tiles' last wave.
//
// fp32 route (flash_kernel): the reference multiplies in fp32, and the fp32
// tolerance (1e-5) rules out TF32 and bf16 products, so fp32 runs on the
// fp32 FMA pipes: one CTA per (q tile of kBQ rows, head, batch), 256
// threads as 16 x 16, each owning a 4 x 4 block of the (kBQ x kBK) score
// tile and, for P.V, 4 rows x D/16 columns of the accumulator; Q and each
// K tile transposed in shared memory, V row-major, P through shared
// memory; row statistics reduced over the 16 threads of a row by shuffles.
//
// Semantics kept from the TPU kernel: scale D^-0.5 applied to q.k in fp32;
// causal masking compares positions from index 0 of q and of k (col <= row,
// the top-left alignment, which differs from a bottom-right mask when
// T != S); masked scores are -1e30, m starts at -1e30, keys at col >= S
// contribute exactly 0, l is clamped at 1e-30 before the final division,
// and the output is in q's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // keys per tile
constexpr int kPS = kBQ + 4;    // row stride of the transposed P tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* out,
                int B, int H, int Tq, int S, int causal, float scale,
                cudaStream_t s) {
  constexpr size_t bytes = smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_kernel<float, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, Tq, S,
      causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;                 // 16 query rows each
constexpr int kMmaThreads = kWarps * 32;
constexpr int kMmaBQ = kWarps * 16;       // query rows per CTA
constexpr int kMmaBK = 64;                // keys per tile
constexpr int kStages = 2;                // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` of row `r` in a tile of rows of
// `kChunks` chunks: the chunk index XOR (r & 7), so the 8 rows that an
// ldmatrix phase reads at one logical chunk sit in 8 distinct bank groups.
template <int kChunks>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * kChunks + (c ^ (r & 7))) * 16u;
}

// 16 bytes global -> shared, zero-filled where `valid` is false.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as a bf16 pair hi and the rounding residue as a pair lo, so
// that hi + lo carries ~16 bits of each value.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// rows x D bf16 from `src` (row-major, rows >= n_valid zero-filled) into
// the swizzled tile at shared address `dst`, one 16-byte cp.async each.
template <int D, int kRows>
__device__ __forceinline__ void load_tile_async(
    const __nv_bfloat16* __restrict__ src, uint32_t dst, int n_valid) {
  constexpr int kChunks = D / 8;
  static_assert((kRows * kChunks) % kMmaThreads == 0, "tile split");
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kMmaThreads; ++i) {
    const int x = threadIdx.x + i * kMmaThreads;
    const int r = x / kChunks;
    const int c = x % kChunks;
    const bool valid = r < n_valid;
    // a zero-filled chunk reads nothing; its address stays in the tensor
    cp_async16(dst + swz<kChunks>(r, c),
               src + (valid ? (size_t)r * D + c * 8 : 0), valid);
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kMmaBQ + 2 * kStages * kMmaBK) * D * 2;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int H, int Tq, int S,
                 int causal, float scale) {
  constexpr int kChunks = D / 8;          // 16-byte chunks per row
  constexpr int kTile = kMmaBK * D * 2;   // bytes of one K or V tile
  constexpr int kKSteps = D / 16;         // k16 steps of Q.K^T
  constexpr int kNS = kMmaBK / 8;         // n8 score tiles per key tile
  constexpr int kNO = D / 8;              // n8 output tiles
  extern __shared__ uint4 smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sKV = sQ + kMmaBQ * D * 2;   // stage s: K, then V

  const int n_qt = (Tq + kMmaBQ - 1) / kMmaBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * kMmaBQ;   // longest first
  const size_t bh = (size_t)blockIdx.y * H + blockIdx.x;
  const __nv_bfloat16* kp = k + bh * S * D;
  const __nv_bfloat16* vp = v + bh * S * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                 // fragment row (and row + 8)
  const int t = lane % 4;                 // fragment column pair

  int n_kt = (S + kMmaBK - 1) / kMmaBK;
  if (causal) n_kt = min(n_kt, (q0 + kMmaBQ - 1) / kMmaBK + 1);

  auto load_kv = [&](int kt) {
    if (kt < n_kt) {
      const uint32_t st = sKV + (kt % kStages) * 2 * kTile;
      const int k0 = kt * kMmaBK;
      load_tile_async<D, kMmaBK>(kp + (size_t)k0 * D, st, S - k0);
      load_tile_async<D, kMmaBK>(vp + (size_t)k0 * D, st + kTile, S - k0);
    }
    cp_async_commit();   // an empty group keeps the ring's count uniform
  };

  load_tile_async<D, kMmaBQ>(q + (bh * Tq + q0) * D, sQ, Tq - q0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_kv(s);   // Q joins group 0
  cp_async_wait<kStages - 2>();
  __syncthreads();

  // this warp's 16 Q rows as A fragments, for every k16 step
  uint32_t qf[kKSteps][4];
  {
    const int r = warp * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      ldsm_x4(sQ + swz<kChunks>(r, 2 * kk + (lane >> 4)), qf[kk]);
    }
  }

  float o[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};        // rows g and g + 8
  float l[2] = {0.f, 0.f};                // this thread's partial sums
  const int row0 = q0 + warp * 16 + g;

  for (int kt = 0; kt < n_kt; ++kt) {
    load_kv(kt + kStages - 1);            // next tiles fly during the MMAs
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const uint32_t sK = sKV + (kt % kStages) * 2 * kTile;
    const uint32_t sV = sK + kTile;
    const int k0 = kt * kMmaBK;

    // S = Q.K^T: a K row is a B column, so no transpose
    float s[kNS][4];
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kNS / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(sK + swz<kChunks>(16 * j + (lane & 7) + (lane >> 4) * 8,
                                  2 * kk + ((lane >> 3) & 1)),
                b);
        mma_bf16(s[2 * j], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * j + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, mask where the tile crosses the diagonal or the S edge
    const bool masked = (causal && k0 + kMmaBK - 1 > q0) || k0 + kMmaBK > S;
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (masked) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= S) {
            x = -INFINITY;        // no such key: probability exactly 0
          } else if (causal && col > row) {
            x = kNegInf;
          }
        }
        s[n][e] = x;
      }
    }

    // online softmax: row max over the quad, p in fp32, rescale O
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kNS; ++n) {
        mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = exp2f((m[h] - m_new) * kLog2e);
      m[h] = m_new;
      const float ms = m_new * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kNS; ++n) {
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = exp2f(fmaf(s[n][e], kLog2e, -ms));
          s[n][e] = p;
          sum += p;
        }
      }
      l[h] = l[h] * alpha[h] + sum;
    }
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P.V, P = hi + lo straight from the S registers
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < kNO / 2; ++j) {
        uint32_t b[4];
        ldsm_x4_trans(sV + swz<kChunks>(16 * kk + (lane & 15),
                                        2 * j + (lane >> 4)),
                      b);
        mma_bf16(o[2 * j], hi, b[0], b[1]);
        mma_bf16(o[2 * j], lo, b[0], b[1]);
        mma_bf16(o[2 * j + 1], hi, b[2], b[3]);
        mma_bf16(o[2 * j + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

  // epilogue: O / max(l, 1e-30) as bf16 into this warp's rows of the Q
  // tile (only this warp read them), then 16-byte chunks to global
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  char* sOut = reinterpret_cast<char*>(smem);
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(sOut + swz<kChunks>(r, n) + 4 * t) =
          __floats2bfloat162_rn(o[n][2 * h] / l[h], o[n][2 * h + 1] / l[h]);
    }
  }
  __syncwarp();
  __nv_bfloat16* op = out + (bh * Tq + q0) * D;
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int x = lane + 32 * i;
    const int r = warp * 16 + x / kChunks;
    const int c = x % kChunks;
    if (q0 + r < Tq) {
      *reinterpret_cast<uint4*>(op + (size_t)r * D + c * 8) =
          *reinterpret_cast<const uint4*>(sOut + swz<kChunks>(r, c));
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int H, int Tq, int S, int causal, float scale,
                cudaStream_t s) {
  constexpr size_t bytes = mma_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Tq + kMmaBQ - 1) / kMmaBQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B, n_qt);
  flash_mma_kernel<D><<<grid, kMmaThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), H, Tq, S, causal, scale);
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
    return bf16 ? launch_bf16<64>(q, k, v, out, B, H, Tq, S, causal, scale, s)
                : launch_fp32<64>(q, k, v, out, B, H, Tq, S, causal, scale,
                                  s);
  }
  if (D == 128) {
    return bf16 ? launch_bf16<128>(q, k, v, out, B, H, Tq, S, causal, scale,
                                   s)
                : launch_fp32<128>(q, k, v, out, B, H, Tq, S, causal, scale,
                                   s);
  }
  return (int)cudaErrorInvalidValue;
}
