// Paged decode attention under GQA, bf16 in and out, fp32 accumulation.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_attention -> pallas_call, body _kernel): one query token per
// sequence attends the paged KV pool through its block-table row, with an
// online softmax over tiles of tokens.
//
// What bounds it on the card: HBM bytes.  Each (row, KV head) reads its
// context's K and V once, ctx * D * 2 B each, and does ~2 * group flops per
// byte read -- far below the H100's ~295 flop/byte ridge.  So the design
// only tries to stream K/V at full width: 16-byte loads, neighbouring
// threads on neighbouring addresses, and every byte read once per CTA with
// the whole GQA group (6 query heads at qwen2-1.5b) reusing it from
// registers.  Nothing is written back but the (group, D) output.
//
// Grid: one CTA per (KV head, row).  The CTA reads its own block-table row
// (the counterpart of the TPU kernel's scalar prefetch) and walks the
// row's tokens in tiles of kTile.  D / 8 threads share one token row (8
// bf16 = 16 B each): they dot their slice of K with the group's queries,
// reduce over the row with shuffles and write the group's scores for the
// tile to shared memory; the same threads hold that token's V slice in
// registers for the P.V update after the tile's softmax.  m, l and the
// (group x D) fp32 accumulator stay on chip until the final bf16 write.
//
// Semantics kept exactly from the TPU kernel:
//   * positions >= ctx inside the walk score -1e30 (not -inf), m starts at
//     -1e30 and l is clamped at 1e-30, so a row with ctx == 0 returns the
//     uniform mean of V over its table's (page-tile padded) pages;
//   * the table is padded to a multiple of the TPU kernel's page tile with
//     page 0, which only a ctx == 0 (or ctx > table) row can see;
//   * block ids are clamped into [0, nb): a trash-page or stale row reads
//     only valid pool memory.
// Later work (not here): split-KV across CTAs for small batches, wgmma for
// the group x tile products, TMA page loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kTile = 64;       // tokens per softmax tile (2 per lane)
constexpr int kMaxGroup = 8;    // query heads per KV head
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pool,
                       const __nv_bfloat16* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       __nv_bfloat16* __restrict__ out,
                       int Hq, int Hkv, int bs, int nb, int n_pages,
                       int n_pages_padded, float scale) {
  constexpr int R = D / 8;              // threads per token row
  constexpr int ROWS = kThreads / R;    // token rows in flight per CTA
  constexpr int TPT = kTile / ROWS;     // tokens per thread per tile
  static_assert(kTile % ROWS == 0, "tile must split over the rows");

  __shared__ float q_s[kMaxGroup][D];
  __shared__ float s_s[kMaxGroup][kTile];
  __shared__ float red_s[ROWS][kMaxGroup][D];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int r = tid / R;                // token row of this thread
  const int c = tid % R;                // 16-byte slice of the row
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const __nv_bfloat16* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i / D][i % D] = __bfloat162float(qb[i]);
  }
  if (tid < kMaxGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int ctx = context_lens[b];
  const int n_tab = n_pages_padded * bs;
  const int n_walk = ctx > 0 ? min(ctx, n_tab) : n_tab;
  const int* bt = block_tables + (size_t)b * n_pages;

  float acc[kMaxGroup][8];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  __syncthreads();

  for (int base = 0; base < n_walk; base += kTile) {
    uint4 vreg[TPT];
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int tl = i * ROWS + r;
      const int t = base + tl;
      float part[kMaxGroup];
      if (t < n_walk) {
        const int page = t / bs;
        const int off = t - page * bs;
        int blk = page < n_pages ? bt[page] : 0;
        blk = min(max(blk, 0), nb - 1);
        const size_t row = (((size_t)blk * bs + off) * Hkv + h) * D + c * 8;
        const uint4 kraw = *reinterpret_cast<const uint4*>(k_pool + row);
        vreg[i] = *reinterpret_cast<const uint4*>(v_pool + row);
        const __nv_bfloat16* kh = reinterpret_cast<const __nv_bfloat16*>(&kraw);
        float kf[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[j] = __bfloat162float(kh[j]);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          float sacc = 0.f;
          if (g < G) {
#pragma unroll
            for (int j = 0; j < 8; ++j) sacc += q_s[g][c * 8 + j] * kf[j];
          }
          part[g] = sacc;
        }
      } else {
        vreg[i] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) part[g] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
        for (int o = R / 2; o > 0; o >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
      }
      if (c == 0) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          // -inf past the walk: such slots get probability exactly 0 even
          // in a ctx == 0 row, where the masked in-walk slots get 1
          if (g < G) {
            s_s[g][tl] = t >= n_walk ? -INFINITY
                                     : (t < ctx ? part[g] * scale : kNegInf);
          }
        }
      }
    }
    __syncthreads();

    // online softmax over the tile: one warp per query head
    for (int g = warp; g < G; g += kThreads / 32) {
      const float x0 = s_s[g][lane];
      const float x1 = s_s[g][lane + 32];
      float mt = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mt);
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      s_s[g][lane] = p0;
      s_s[g][lane + 32] = p1;
      float ps = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + ps;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const float a = alpha_s[g];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] *= a;
      }
    }
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int tl = i * ROWS + r;
      const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vreg[i]);
      float vf[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) vf[j] = __bfloat162float(vh[j]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          const float p = s_s[g][tl];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[g][j] += p * vf[j];
        }
      }
    }
    __syncthreads();
  }

  // sum the per-row partial accumulators, normalise, write bf16
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
#pragma unroll
      for (int j = 0; j < 8; ++j) red_s[r][g][c * 8 + j] = acc[g][j];
    }
  }
  __syncthreads();
  __nv_bfloat16* ob = out + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float sum = 0.f;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) sum += red_s[rr][g][d];
    ob[i] = __float2bfloat16(sum / fmaxf(l_s[g], 1e-30f));
  }
}

}  // namespace

// q (B, Hq, D), k_pool / v_pool (nb, bs, Hkv, D), out (B, Hq, D): bf16,
// contiguous, 16-byte aligned.  block_tables (B, n_pages) and
// context_lens (B,): int32.  n_pages_padded: the table width rounded up to
// the TPU kernel's page tile.  Launches on ``stream`` and returns the
// cudaGetLastError() code (0 = launched).
extern "C" int fs_paged_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* context_lens, void* out,
    int B, int Hq, int Hkv, int D, int bs, int nb, int n_pages,
    int n_pages_padded, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup ||
      bs <= 0 || nb <= 0 || n_pages <= 0 || n_pages_padded < n_pages ||
      B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(Hkv, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pool);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pool);
  const auto* btp = static_cast<const int*>(block_tables);
  const auto* cp = static_cast<const int*>(context_lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D != 128) {   // qwen2-1.5b's head_dim, the one served
    return (int)cudaErrorInvalidValue;
  }
  paged_attention_kernel<128><<<grid, kThreads, 0, s>>>(
      qp, kp, vp, btp, cp, op, Hq, Hkv, bs, nb, n_pages, n_pages_padded,
      scale);
  return (int)cudaGetLastError();
}
