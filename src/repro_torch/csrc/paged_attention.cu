// Paged decode attention under GQA, fp32 accumulation: split-KV
// ("flash-decoding"), bf16 on Hopper's tensor cores, fp32 on the CUDA
// cores; any GQA group.  In bf16 every head_dim D that is a multiple of 16
// up to 256 is its own instance (its combine too); in fp32 one instance
// serves each 32 of D (the lanes past D idle), and one combine takes D at
// run time.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_attention -> pallas_call, body _kernel): one query token per
// sequence attends the paged KV pool through its block-table row, with an
// online softmax over tiles of tokens.  The TPU kernel takes any D, group
// and dtype; so do these two kernels, within D % 16 == 0 and D <= 256.
//
// What bounds it on the card: HBM bytes.  Each (row, KV head) reads its
// walked K and V once, 2 D bytes per token each in bf16, and does ~2 *
// group flops per byte, far below the H100's ~295 flop/byte bf16 ridge.
// At qwen2-1.5b's decode (B 32, 128 pages of 16, contexts 0..2048, Hq 12
// / Hkv 2, D 128) that is 33.8 MB, 0.0101 ms at 3.35 TB/s (published H100
// SXM peak at its 700 W limit; chip_smoke.py computes the bound from its
// inputs).  Reaching it takes tens of KB in flight on every SM at once, so
// the design spreads the walk over the whole card and keeps page loads in
// flight:
//
//   * Split-KV.  The grid is (Hkv x head tiles, B, n_splits): each CTA
//     walks one contiguous chunk of its row's padded table (a multiple of
//     the 64-token step and of the page size) for up to 8 query heads of
//     one KV head (a head tile: the mma's N; a group of 16 is two tiles,
//     each reading the K/V once).  The wrapper picks n_splits from shapes
//     alone (B, Hkv, head tiles, the padded table, and the CTAs resident
//     per SM at this D and dtype; kernels/paged_attention.py split_plan),
//     aiming at two waves of the resident CTAs, so no host sync reads
//     context_lens and the launch depends only on shapes.  A CTA whose
//     chunk starts at or past the row's walk writes an empty partial (m =
//     -inf, l = 0) and exits; at batch 8 most CTAs of the padded table do,
//     at the cost of a launch slot each.
//   * bf16: four warps per CTA, each with its own stream of 16-token
//     sub-tiles (sub-tile j of the chunk goes to warp j % 4) and its own
//     online softmax state, so no barrier is taken per tile: a warp waits
//     only for its own copies.  Each warp keeps a 2-stage ring of K and V
//     sub-tiles in shared memory, filled by 16-byte cp.async.cg copies
//     started before the sub-tile in the other stage is reduced; a token's
//     head row is 2 D contiguous bytes of the (nb, bs, Hkv, D) pool, and
//     its 16-byte chunks are XOR-swizzled by (row & 7) so ldmatrix reads
//     are free of bank conflicts (a ring row is D rounded up to 64
//     elements, so the swizzle stays inside it).  The CTA stages its
//     chunk's block-table entries in shared memory first (the TPU kernel's
//     scalar prefetch), with the TPU index rule applied, while ctx is
//     read.  The ring is 512 bytes per element of a ring row: 32 KB at D
//     <= 64, 64 KB at D 128, 128 KB at D 256; with at most 4 KB of table,
//     the SM's 228 KB hold 3 CTAs at D 128 (12 warps, 96 KB of copies in
//     flight), 1 at D 256, and at most kMaxResident, which keeps 128
//     registers a thread.  (At D 128 a third stage allowed two CTAs per
//     SM and left the ragged B 32 batch a second wave: ~300 live CTAs on
//     264 slots.)
//   * Q.K^T on the tensor cores, tokens on M and the head tile on N:
//     S^T (16 tokens x 8 heads) = K (16 x D) . Q^T by mma.sync m16n8k16
//     (bf16 in, fp32 accumulate; bf16 x bf16 products are exact in fp32).
//     K is the A operand by ldmatrix straight from the ring; Q^T's B
//     fragments are read from global once (a tile of 6 padded to 8 with
//     zero rows).  The group on N wastes 2 of 8 columns where the group on
//     M (padded to 16) would waste 10 of 16.
//   * P.V on the tensor cores too: O^T (D x 8 heads) += V^T (D x 16
//     tokens) . P, V^T by ldmatrix.trans from the ring.  P's B fragments are
//     the transpose of S^T's accumulator fragments, one movmatrix.trans per
//     8 x 8 half.  Split P: rounding p once to bf16 misses this repo's
//     one-ulp gate (1e-3 + 2^-7 |ref|) on rows of 1-64 tokens
//     (tests/test_torch_kernels.py shows it on the CPU).  Two terms, hi =
//     bf16(p) and lo = bf16(p - hi), pass the gate but leave 2^-18 p, which
//     moves fp32 sums ~50x as far from the plain version's as fp32 P.V
//     does and flips bf16 roundings as often; so p goes in three bf16
//     terms (hi, then the residues), which carry its 24 bits, and each runs
//     against every V fragment, smallest first: 3x the P.V products of one
//     term, on a kernel bound by bytes.  l is summed from the fp32 p.
//   * fp32: the same grid, partition, table staging and merges, on the
//     CUDA cores in plain fp32 (no TF32: the reference holds fp32 to
//     1e-5).  A warp takes 32-token sub-tiles (one token a lane: q.k of
//     the head tile against the lane's K row, q from shared memory), one
//     online-softmax update per sub-tile, then P.V token by token with
//     the lanes on D (p by shuffle, each V row read coalesced).  Simple
//     and right: it serves the reference's fp32 cases, not a model.
//   * Deterministic combine: a CTA merges its four warps' (m, l, O) in a
//     fixed order through shared memory; with one split it writes the
//     output itself, else it writes the fp32 partial (m, l, un-normalised
//     O) to a workspace the wrapper allocates, and a second small kernel,
//     one CTA per query head, merges the splits in split order: M = max
//     m_s, O = sum e^(m_s - M) O_s / max(sum e^(m_s - M) l_s, 1e-30),
//     rounded to the output dtype once.  No float atomics, so two launches
//     on the same inputs are bit-equal.
//     A second launch rather than a last-CTA ticket: a ticket needs a
//     zeroed counter that outlives the call (shared by every stream) or a
//     memset per call, itself a launch; the decode step is host-bound.
//
// Registers at D 128 bf16: 160 a thread in the split kernel (O^T is 32
// fp32, Q^T's fragments 16), 32 in the combine, no spills; 252 at D 256;
// the fp32 kernel holds 128 (its bound at 4 CTAs an SM), and its
// instances past D 32 spill 12-140 bytes a thread (chip_smoke.py prints
// ptxas -v for every instance).  On an H100 80GB HBM3 at 700 W
// (chip_smoke.py) the D-128 pair takes 0.027 ms at B 32 x 128 pages, 37 %
// of its bound, and 0.010 ms at the engine's B 8 x 64 pages, where the
// bound is 0.001 ms and the chain of dependent loads (ctx and table, then
// K/V, then the partials) and two launches set the time.  Next steps: a
// device-built list of the live (row, chunk) pairs instead of a dense grid
// whose late CTAs exit at once; the combine folded into the last CTA of
// each row; TMA page loads through mbarriers from a producer warp (one
// thread per row instead of D / 8); wgmma.
//
// Semantics kept exactly from the TPU kernel:
//   * scores are q.k in fp32 times scale; positions >= ctx inside the walk
//     score -1e30 (not -inf), m starts at -1e30 and l is clamped at 1e-30
//     once, on the final sum, so a row with ctx <= 0 returns the uniform
//     mean of V over its (page-tile padded) table;
//   * the table is padded with page 0 to a multiple of the TPU kernel's page
//     tile; a row walks min(ctx, table) tokens, the whole table when ctx <=
//     0; positions past the walk contribute exactly 0, as the TPU kernel's
//     -1e30 gives them next to a real score;
//   * block ids follow the TPU index map: a negative id counts from the end
//     of the pool, then it is clamped into [0, nb).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSub = 16;                 // tokens per bf16 warp sub-tile (M)
constexpr int kSubF32 = 32;              // tokens per fp32 warp sub-tile
constexpr int kStep = kWarps * kSub;     // tokens per CTA step; chunk unit
constexpr int kStages = 2;               // ring depth per warp
constexpr int kMaxGroup = 8;             // query heads a CTA takes (N)
constexpr int kMaxChunkPages = 1024;     // table entries a CTA stages
constexpr int kMaxSplits = 2048;         // the combine's m, l, w: 24 KB
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// CTAs resident per SM: the SM's shared memory (228 KB) over a CTA's own
// (its buffers, at most kMaxChunkPages table entries, the 1 KB the system
// reserves per CTA), and at most kMaxResident, where each thread keeps 128
// registers (65536 / (4 x 128)).  kernels/paged_attention.py's
// ctas_per_sm computes the same numbers for split_plan.
constexpr int kSmemPerSm = 233472;
constexpr int kSmemPerCta = 1024;
constexpr int kMaxResident = 4;
__host__ __device__ constexpr int resident_ctas(int smem_bytes) {
  return kSmemPerSm / (smem_bytes + kMaxChunkPages * 4 + kSmemPerCta) <
                 kMaxResident
             ? kSmemPerSm / (smem_bytes + kMaxChunkPages * 4 + kSmemPerCta)
             : kMaxResident;
}

// the warps' merge buffer: m and l of each head of the tile, then its O
template <int kD>
__host__ __device__ constexpr int merge_bytes() {
  return kWarps * kMaxGroup * (kD + 2) * 4;
}

// The bf16 kernel's ring at head_dim kD: a ring row holds kD rounded up to
// 64 elements (a multiple of 8 16-byte chunks, so the swizzle stays in the
// row), 2 stages of K and V sub-tiles per warp.
template <int kD>
struct Bf16Ring {
  static constexpr int kChunks = kD / 8;                   // 16-byte chunks
  static constexpr int kRowChunks = (kChunks + 7) / 8 * 8; // ring row
  static constexpr int kSubBytes = kSub * kRowChunks * 16;
  static constexpr int kBytes = kWarps * kStages * 2 * kSubBytes;
  static constexpr int kResident = resident_ctas(kBytes);
  static_assert(kD % 16 == 0 && kD >= 16 && kD <= kMaxD, "head_dim");
  static_assert(merge_bytes<kD>() <= kBytes,
                "the warps' merge buffer reuses the ring");
};

// The fp32 kernel's shared memory at head_dim D: the head tile's q, then
// the merge buffer.  One instance serves every D of 32 (kE - 1) < D <= 32
// kE (kE O elements a lane); its residency is that of the largest.
__host__ __device__ constexpr int f32_smem_bytes(int D) {
  return kMaxGroup * D * 4 + kWarps * kMaxGroup * (D + 2) * 4;
}
template <int kE>
struct F32Lanes {
  static constexpr int kResident = resident_ctas(f32_smem_bytes(32 * kE));
  static_assert(kE >= 1 && 32 * kE <= kMaxD, "head_dim");
};

// the combine's threads: one per output element, whole warps
template <int kD>
__host__ __device__ constexpr int combine_threads() {
  return (kD + 31) / 32 * 32;
}

// The TPU index map's block for table entry `id` of a pool of nb blocks.
__device__ __forceinline__ int block_index(int id, int nb) {
  if (id < 0) id += nb;
  return id < 0 ? 0 : (id >= nb ? nb - 1 : id);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` of token row `r` in a sub-tile of
// kRowChunks-chunk rows: the chunk index XOR (r & 7), so the 8 rows an
// ldmatrix phase reads at one logical chunk sit in 8 distinct bank groups.
template <int kRowChunks>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * kRowChunks + (c ^ (r & 7))) * 16u;
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

// The transpose of an 8 x 8 b16 matrix held one row pair per thread (the
// mma accumulator / ldmatrix fragment layout), in the same layout.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
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

// (x0, x1) as three bf16 pairs: hi = bf16(x), mid = bf16(x - hi) and lo =
// bf16(x - hi - mid), each residue exact in fp32, so that hi + mid + lo
// carries the 24 bits of each fp32 value.
__device__ __forceinline__ void split3_bf16(float x0, float x1,
                                            uint32_t (&parts)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    parts[i] = as_u32(h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

__device__ __forceinline__ float exp_diff(float a, float b) {
  return exp2f((a - b) * kLog2e);   // e^(a - b); exactly 1 where a == b
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Workspace layout for n_parts = B * Hkv * n_splits partials of G heads:
// m [n_parts][G], l [n_parts][G], O [n_parts][G][D], all fp32.
struct Partials {
  float* m;
  float* l;
  float* o;
  __device__ Partials(float* ws, size_t n_parts, int G)
      : m(ws), l(ws + n_parts * G), o(ws + 2 * n_parts * G) {}
};

// This CTA's place in the grid: KV head h, its head tile's first query
// head g0 (of the group) and its Gt heads, row b, split.
struct Cta {
  int G, h, g0, Gt, b, split, n_splits;
  __device__ Cta(int Hq, int Hkv) {
    G = Hq / Hkv;
    const int n_tiles = (G + kMaxGroup - 1) / kMaxGroup;
    h = blockIdx.x / n_tiles;
    g0 = (blockIdx.x % n_tiles) * kMaxGroup;
    Gt = min(kMaxGroup, G - g0);
    b = blockIdx.y;
    split = blockIdx.z;
    n_splits = gridDim.z;
  }
};

// Stage the chunk's table entries (from token c0, a multiple of bs), the
// index rule applied; read whether or not ctx reaches them, so the reads
// overlap ctx's.
__device__ __forceinline__ void stage_table(int* tbl, const int* block_tables,
                                            int b, int c0, int chunk, int bs,
                                            int nb, int n_pages,
                                            int n_pages_padded) {
  const int p0 = c0 / bs;
  const int n_cp = min(chunk / bs, n_pages_padded - p0);
  const int* bt = block_tables + (size_t)b * n_pages;
  for (int i = threadIdx.x; i < n_cp; i += kThreads) {
    const int page = p0 + i;
    tbl[i] = block_index(page < n_pages ? bt[page] : 0, nb);
  }
}

// Merge the four warps' (m, l, O) of the tile's heads in warp order (mw,
// lw: [kWarps][kMaxGroup]; ow: [kWarps][kMaxGroup][kD], all written and
// synchronised by the caller), then write the output (one split) or this
// split's partial.  kD: the head_dim (a constant in the bf16 kernel).
template <typename OutT>
__device__ __forceinline__ void merge_warps(const float* mw, const float* lw,
                                            const float* ow, const Cta& c,
                                            size_t part, const Partials& P,
                                            OutT* out, int Hq, int kD) {
  for (int x = threadIdx.x; x < c.Gt * kD; x += kThreads) {
    const int g = x / kD;
    const int d = x % kD;
    float M = mw[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, mw[w * kMaxGroup + g]);
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp_diff(mw[w * kMaxGroup + g], M);
      acc += f * ow[(w * kMaxGroup + g) * kD + d];
      lsum += f * lw[w * kMaxGroup + g];
    }
    const int gg = c.g0 + g;               // the query head in the group
    if (c.n_splits == 1) {
      store(out + ((size_t)c.b * Hq + (size_t)c.h * c.G + gg) * kD + d,
            acc / fmaxf(lsum, 1e-30f));
    } else {
      P.o[(part * c.G + gg) * kD + d] = acc;
      if (d == 0) {
        P.m[part * c.G + gg] = M;
        P.l[part * c.G + gg] = lsum;
      }
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, Bf16Ring<kD>::kResident)
paged_attention_split_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k_pool,
                             const __nv_bfloat16* __restrict__ v_pool,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ context_lens,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ ws, int Hq, int Hkv, int bs,
                             int nb, int n_pages, int n_pages_padded,
                             int chunk, float scale) {
  using R = Bf16Ring<kD>;
  constexpr int kChunks = R::kChunks;      // 16-byte chunks per token row
  constexpr int kRowChunks = R::kRowChunks;
  constexpr int kSubBytes = R::kSubBytes;
  constexpr int kKSteps = kD / 16;         // k16 steps of K.Q^T
  constexpr int kMT = kD / 16;             // m16 tiles of O^T
  extern __shared__ uint4 smem[];
  char* smem_c = reinterpret_cast<char*>(smem);
  int* tbl = reinterpret_cast<int*>(smem_c + R::kBytes);

  const Cta c(Hq, Hkv);
  const int h = c.h;
  const int b = c.b;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;                 // fragment row (and row + 8)
  const int t4 = lane % 4;                 // fragment column pair

  const int ctx = context_lens[b];
  const int c0 = c.split * chunk;
  const size_t part = ((size_t)b * Hkv + h) * c.n_splits + c.split;
  const Partials P(ws, (size_t)gridDim.y * Hkv * c.n_splits, c.G);

  stage_table(tbl, block_tables, b, c0, chunk, bs, nb, n_pages,
              n_pages_padded);

  // Q^T's B fragments: column gq is query head h * G + g0 + gq (zero if
  // past the tile)
  uint32_t qb[kKSteps][2];
  {
    const bool live = gq < c.Gt;
    const __nv_bfloat16* qr =
        q + ((size_t)b * Hq + (size_t)h * c.G + c.g0 + (live ? gq : 0)) * kD;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      qb[kk][0] = live ? *reinterpret_cast<const uint32_t*>(
                             qr + 16 * kk + 2 * t4) : 0u;
      qb[kk][1] = live ? *reinterpret_cast<const uint32_t*>(
                             qr + 16 * kk + 8 + 2 * t4) : 0u;
    }
  }

  const int n_tab = n_pages_padded * bs;
  const int n_walk = ctx > 0 ? min(ctx, n_tab) : n_tab;
  if (c0 >= n_walk) {                      // nothing of this row here
    if (tid < c.Gt) {
      P.m[part * c.G + c.g0 + tid] = -INFINITY;
      P.l[part * c.G + c.g0 + tid] = 0.f;
    }
    return;
  }
  const int c_end = min(c0 + chunk, n_walk);
  __syncthreads();                         // the table is staged

  const int n_sub = (c_end - c0 + kSub - 1) / kSub;
  const int n_it = n_sub > warp ? (n_sub - warp + kWarps - 1) / kWarps : 0;
  const uint32_t ring = smem_u32(smem) + warp * kStages * 2 * kSubBytes;

  // copies of this warp's it-th sub-tile (K then V) into its ring stage;
  // tokens past c_end are zero-filled (their score is then -inf)
  auto load = [&](int it) {
    if (it < n_it) {
      const uint32_t st = ring + (it % kStages) * 2 * kSubBytes;
      const int base = (warp + it * kWarps) * kSub;   // relative to c0
#pragma unroll
      for (int i = 0; i < kSub * kChunks / 32; ++i) {
        const int x = lane + 32 * i;
        const int r = x / kChunks;
        const int ch = x % kChunks;
        const int rel = base + r;
        const bool valid = c0 + rel < c_end;
        size_t off = 0;   // a zero-filled chunk reads nothing
        if (valid) {
          const int blk = tbl[rel / bs];
          off = (((size_t)blk * bs + rel % bs) * Hkv + h) * kD + ch * 8;
        }
        cp_async16(st + swz<kRowChunks>(r, ch), k_pool + off, valid);
        cp_async16(st + kSubBytes + swz<kRowChunks>(r, ch), v_pool + off,
                   valid);
      }
    }
    cp_async_commit();   // an empty group keeps the ring's count uniform
  };

  float o[kMT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};         // heads 2 t4 and 2 t4 + 1
  float l[2] = {0.f, 0.f};                 // this thread's partial sums

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s);
  for (int it = 0; it < n_it; ++it) {
    load(it + kStages - 1);                // the next sub-tile flies
    cp_async_wait<kStages - 1>();
    __syncwarp();                          // every lane's copies landed
    const uint32_t sK = ring + (it % kStages) * 2 * kSubBytes;
    const uint32_t sV = sK + kSubBytes;
    const int base = c0 + (warp + it * kWarps) * kSub;

    // S^T = K . Q^T: rows are tokens, columns query heads
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t a[4];
      ldsm_x4(sK + swz<kRowChunks>(lane & 15, 2 * kk + (lane >> 4)), a);
      mma_bf16(s, a, qb[kk][0], qb[kk][1]);
    }

    // s[e]: token base + gq (+ 8 for e >= 2), head 2 t4 + (e & 1)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = base + gq + (e >> 1) * 8;
      s[e] = t >= c_end ? -INFINITY : (t < ctx ? s[e] * scale : kNegInf);
    }
    float alpha[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float mx = fmaxf(s[k], s[k + 2]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[k], mx);
      alpha[k] = exp_diff(m[k], m_new);
      s[k] = exp_diff(s[k], m_new);
      s[k + 2] = exp_diff(s[k + 2], m_new);
      l[k] = l[k] * alpha[k] + s[k] + s[k + 2];
      m[k] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[1];
      o[i][2] *= alpha[0];
      o[i][3] *= alpha[1];
    }

    // P (16 tokens x 8 heads) in three bf16 terms as B fragments: the
    // transpose of the two 8 x 8 halves of S^T's accumulator
    uint32_t p0[3], p1[3];
    split3_bf16(s[0], s[1], p0);           // tokens 0-7
    split3_bf16(s[2], s[3], p1);           // tokens 8-15
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      p0[j] = movmatrix_trans(p0[j]);
      p1[j] = movmatrix_trans(p1[j]);
    }

    // O^T += V^T . P, the smallest term first
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      uint32_t a[4];
      ldsm_x4_trans(sV + swz<kRowChunks>((lane & 7) + ((lane >> 4) << 3),
                                         2 * i + ((lane >> 3) & 1)),
                    a);
#pragma unroll
      for (int j = 2; j >= 0; --j) mma_bf16(o[i], a, p0[j], p1[j]);
    }
    __syncwarp();                          // the stage may be refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int k = 0; k < 2; ++k) {
    l[k] += __shfl_xor_sync(0xffffffffu, l[k], 4);
    l[k] += __shfl_xor_sync(0xffffffffu, l[k], 8);
    l[k] += __shfl_xor_sync(0xffffffffu, l[k], 16);
  }

  // merge the four warps in warp order through the (now idle) ring
  __syncthreads();
  float* mw = reinterpret_cast<float*>(smem);   // [kWarps][kMaxGroup]
  float* lw = mw + kWarps * kMaxGroup;
  float* ow = lw + kWarps * kMaxGroup;          // [kWarps][kMaxGroup][kD]
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int g = 2 * t4 + k;
    if (gq == 0) {
      mw[warp * kMaxGroup + g] = m[k];
      lw[warp * kMaxGroup + g] = l[k];
    }
    float* og = ow + (warp * kMaxGroup + g) * kD;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      og[16 * i + gq] = o[i][k];
      og[16 * i + gq + 8] = o[i][k + 2];
    }
  }
  __syncthreads();
  merge_warps(mw, lw, ow, c, part, P, out, Hq, kD);
}

template <int kE>
__global__ void __launch_bounds__(kThreads, F32Lanes<kE>::kResident)
paged_attention_f32_split_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k_pool,
                                 const float* __restrict__ v_pool,
                                 const int* __restrict__ block_tables,
                                 const int* __restrict__ context_lens,
                                 float* __restrict__ out,
                                 float* __restrict__ ws, int Hq, int Hkv,
                                 int bs, int nb, int n_pages,
                                 int n_pages_padded, int chunk,
                                 float scale, int D) {
  extern __shared__ uint4 smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [kMaxGroup][D]
  float* mw = qs + kMaxGroup * D;               // [kWarps][kMaxGroup]
  float* lw = mw + kWarps * kMaxGroup;
  float* ow = lw + kWarps * kMaxGroup;          // [kWarps][kMaxGroup][D]
  int* tbl = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) +
                                    f32_smem_bytes(D));

  const Cta c(Hq, Hkv);
  const int h = c.h;
  const int b = c.b;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int ctx = context_lens[b];
  const int c0 = c.split * chunk;
  const size_t part = ((size_t)b * Hkv + h) * c.n_splits + c.split;
  const Partials P(ws, (size_t)gridDim.y * Hkv * c.n_splits, c.G);

  stage_table(tbl, block_tables, b, c0, chunk, bs, nb, n_pages,
              n_pages_padded);
  // the tile's q rows, zero past the tile
  for (int x = tid; x < kMaxGroup * D; x += kThreads) {
    const int g = x / D;
    qs[x] = g < c.Gt
                ? q[((size_t)b * Hq + (size_t)h * c.G + c.g0 + g) * D +
                    x % D]
                : 0.f;
  }

  const int n_tab = n_pages_padded * bs;
  const int n_walk = ctx > 0 ? min(ctx, n_tab) : n_tab;
  if (c0 >= n_walk) {                      // nothing of this row here
    if (tid < c.Gt) {
      P.m[part * c.G + c.g0 + tid] = -INFINITY;
      P.l[part * c.G + c.g0 + tid] = 0.f;
    }
    return;
  }
  const int c_end = min(c0 + chunk, n_walk);
  __syncthreads();                         // the table and q are staged

  float o[kMaxGroup][kE];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int e = 0; e < kE; ++e) o[g][e] = 0.f;
  }
  float m[kMaxGroup], l[kMaxGroup];        // l: this lane's partial sums
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int n_sub = (c_end - c0 + kSubF32 - 1) / kSubF32;
  for (int j = warp; j < n_sub; j += kWarps) {
    const int base = c0 + j * kSubF32;
    const int n_here = min(kSubF32, c_end - base);
    // this lane's token's scores for the tile's heads
    float s[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
    if (lane < n_here) {
      const int rel = base + lane - c0;
      const float4* kr = reinterpret_cast<const float4*>(
          k_pool + (((size_t)tbl[rel / bs] * bs + rel % bs) * Hkv + h) * D);
#pragma unroll 4
      for (int i = 0; i < D / 4; ++i) {
        const float4 kv = kr[i];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          const float4 qv = reinterpret_cast<const float4*>(qs + g * D)[i];
          s[g] = fmaf(qv.x, kv.x, s[g]);
          s[g] = fmaf(qv.y, kv.y, s[g]);
          s[g] = fmaf(qv.z, kv.z, s[g]);
          s[g] = fmaf(qv.w, kv.w, s[g]);
        }
      }
      const bool in_ctx = base + lane < ctx;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        s[g] = in_ctx ? s[g] * scale : kNegInf;
      }
    } else {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) s[g] = -INFINITY;
    }
    // one online-softmax update per head over the 32 tokens
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      float mx = s[g];
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      s[g] = expf(s[g] - m_new);           // 0 past the walk
      l[g] = l[g] * alpha + s[g];
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < kE; ++e) o[g][e] *= alpha;
    }
    // O += P . V, token by token, the lanes on D
    for (int u = 0; u < n_here; ++u) {
      const int rel = base + u - c0;
      const float* vr =
          v_pool + (((size_t)tbl[rel / bs] * bs + rel % bs) * Hkv + h) * D;
      float vv[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int d = lane + 32 * e;
        vv[e] = d < D ? vr[d] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        const float p = __shfl_sync(0xffffffffu, s[g], u);
#pragma unroll
        for (int e = 0; e < kE; ++e) o[g][e] = fmaf(p, vv[e], o[g][e]);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], w);
    }
  }
  // merge the four warps in warp order
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (lane == 0) {
      mw[warp * kMaxGroup + g] = m[g];
      lw[warp * kMaxGroup + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) ow[(warp * kMaxGroup + g) * D + d] = o[g][e];
    }
  }
  __syncthreads();
  merge_warps(mw, lw, ow, c, part, P, out, Hq, D);
}

// One CTA per (KV head, row, query head of the group), one thread per
// output element (whole warps: threads past D only reduce).  The splits'
// m and l are read once, in parallel, into shared memory with their
// weights e^(m_s - M) (0 for an empty split, m = -inf, whose O is never
// read); then every thread sums its element over the splits in split
// order, the loads independent of each other.  Split 0 always holds a
// token, so M is finite.  kD: the head_dim of a bf16 instance; 0 for the
// fp32 kernel's one instance, which takes D at run time.
template <int kD, typename OutT>
__global__ void __launch_bounds__(kD ? combine_threads<kD>() : kMaxD)
paged_attention_combine_kernel(const float* __restrict__ ws,
                               OutT* __restrict__ out, int Hq, int Hkv,
                               int d_run, int n_splits) {
  const int D = kD ? kD : d_run;
  const int kCT = kD ? combine_threads<kD>() : (int)blockDim.x;
  extern __shared__ float sm[];            // m, then l, then w
  float* ls = sm + n_splits;
  float* w = ls + n_splits;
  __shared__ float red[kMaxD / 32];
  __shared__ float l_sum;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = blockIdx.z;
  const int G = Hq / Hkv;
  const int d = threadIdx.x;
  const size_t part0 = ((size_t)b * Hkv + h) * n_splits;
  const Partials P(const_cast<float*>(ws),
                   (size_t)gridDim.y * Hkv * n_splits, G);

  float M = -INFINITY;                     // a max: the order is free
  for (int s = d; s < n_splits; s += kCT) {
    sm[s] = P.m[(part0 + s) * G + g];
    ls[s] = P.l[(part0 + s) * G + g];
    M = fmaxf(M, sm[s]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  }
  if (d % 32 == 0) red[d / 32] = M;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kCT / 32; ++i) M = fmaxf(M, red[i]);
  for (int s = d; s < n_splits; s += kCT) {
    w[s] = sm[s] == -INFINITY ? 0.f : exp_diff(sm[s], M);
  }
  __syncthreads();
  if (d == 0) {
    float l = 0.f;
    for (int s = 0; s < n_splits; ++s) l = fmaf(w[s], ls[s], l);
    l_sum = l;
  }
  float acc = 0.f;
  if (d < D) {
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s) {
      if (w[s] != 0.f) {
        acc = fmaf(w[s], P.o[((part0 + s) * G + g) * D + d], acc);
      }
    }
  }
  __syncthreads();
  if (d < D) {
    store(out + ((size_t)b * Hq + (size_t)h * G + g) * D + d,
          acc / fmaxf(l_sum, 1e-30f));
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* block_tables;
  const int* context_lens;
  void* out;
  float* ws;
  int B, Hq, Hkv, D, bs, nb, n_pages, n_pages_padded, n_splits, chunk;
  float scale;
  cudaStream_t stream;
};

// The split kernel (its dynamic shared memory: smem_bytes and the
// chunk's table; ``extra``: its arguments past the common ones), then,
// with several splits, the combine (kD: its instance, 0 for run-time D).
template <int kD, typename InT, typename Kernel, typename... Extra>
int launch(const Args& a, Kernel kernel, int smem_bytes, Extra... extra) {
  const int smem = smem_bytes + ((a.chunk / a.bs) * 4 + 15) / 16 * 16;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int G = a.Hq / a.Hkv;
  const int n_tiles = (G + kMaxGroup - 1) / kMaxGroup;
  auto* op = static_cast<InT*>(a.out);
  kernel<<<dim3(a.Hkv * n_tiles, a.B, a.n_splits), kThreads, smem,
           a.stream>>>(
      static_cast<const InT*>(a.q), static_cast<const InT*>(a.k_pool),
      static_cast<const InT*>(a.v_pool), a.block_tables, a.context_lens, op,
      a.ws, a.Hq, a.Hkv, a.bs, a.nb, a.n_pages, a.n_pages_padded, a.chunk,
      a.scale, extra...);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || a.n_splits == 1) return (int)launched;
  paged_attention_combine_kernel<kD, InT>
      <<<dim3(a.Hkv, a.B, G), (a.D + 31) / 32 * 32,
         3 * a.n_splits * sizeof(float), a.stream>>>(a.ws, op, a.Hq, a.Hkv,
                                                     a.D, a.n_splits);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_bf16(const Args& a) {
  return launch<kD, __nv_bfloat16>(a, paged_attention_split_kernel<kD>,
                                   Bf16Ring<kD>::kBytes);
}

template <int kE>
int launch_f32(const Args& a) {
  return launch<0, float>(a, paged_attention_f32_split_kernel<kE>,
                          f32_smem_bytes(a.D), a.D);
}

// every head_dim of the domain: a multiple of 16 up to 256
#define FS_PAGED_ATTENTION_DIMS(X)                                          \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176)   \
  X(192) X(208) X(224) X(240) X(256)

// The split kernel (and the combine) at head_dim D in fp32 or bf16, or
// cudaErrorInvalidValue for arguments outside the kernels' domain.
int paged_attention(bool f32, const void* q, const void* k_pool,
                    const void* v_pool, const void* block_tables,
                    const void* context_lens, void* out, void* workspace,
                    int B, int Hq, int Hkv, int D, int bs, int nb,
                    int n_pages, int n_pages_padded, int n_splits, int chunk,
                    float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || Hq / Hkv > 65535 ||
      bs <= 0 || nb <= 0 || n_pages <= 0 || n_pages_padded < n_pages ||
      B > 65535 || n_splits <= 0 || n_splits > kMaxSplits || chunk <= 0 ||
      chunk % kStep != 0 || chunk % bs != 0 ||
      chunk / bs > kMaxChunkPages ||
      (long long)n_pages_padded * bs > (long long)n_splits * chunk ||
      (long long)(n_splits - 1) * chunk >= (long long)n_pages_padded * bs ||
      (n_splits > 1 && workspace == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k_pool, v_pool, static_cast<const int*>(block_tables),
               static_cast<const int*>(context_lens), out,
               static_cast<float*>(workspace), B, Hq, Hkv, D, bs, nb,
               n_pages, n_pages_padded, n_splits, chunk, scale,
               reinterpret_cast<cudaStream_t>(stream)};
  if (D % 16 != 0 || D < 16 || D > kMaxD) return (int)cudaErrorInvalidValue;
  if (f32) {
    switch ((D + 31) / 32) {
      case 1: return launch_f32<1>(a);
      case 2: return launch_f32<2>(a);
      case 3: return launch_f32<3>(a);
      case 4: return launch_f32<4>(a);
      case 5: return launch_f32<5>(a);
      case 6: return launch_f32<6>(a);
      case 7: return launch_f32<7>(a);
      default: return launch_f32<8>(a);
    }
  }
  switch (D) {
#define FS_CASE(D_) \
  case D_:          \
    return launch_bf16<D_>(a);
    FS_PAGED_ATTENTION_DIMS(FS_CASE)
#undef FS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, D), k_pool / v_pool (nb, bs, Hkv, D), out (B, Hq, D): bf16
// (fs_paged_attention_bf16) or fp32 (fs_paged_attention_f32), contiguous,
// 16-byte aligned; D a multiple of 16 up to 256; any group Hq / Hkv.
// block_tables (B, n_pages) and context_lens (B,): int32.  n_pages_padded:
// the table width rounded up to the TPU kernel's page tile.  The padded
// table's n_pages_padded * bs tokens are split into n_splits <= 2048
// chunks of `chunk` tokens (a multiple of 64 and of bs, at most 1024
// pages; the last chunk may run past the table but not by a whole chunk).
// workspace: (2 + D) * B * Hq * n_splits fp32 when n_splits > 1, else
// unused.  Launches on ``stream`` (two kernels when n_splits > 1) and
// returns the cudaGetLastError() code (0 = launched).
extern "C" int fs_paged_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* context_lens, void* out,
    void* workspace, int B, int Hq, int Hkv, int D, int bs, int nb,
    int n_pages, int n_pages_padded, int n_splits, int chunk, float scale,
    void* stream) {
  return paged_attention(false, q, k_pool, v_pool, block_tables,
                         context_lens, out, workspace, B, Hq, Hkv, D, bs, nb,
                         n_pages, n_pages_padded, n_splits, chunk, scale,
                         stream);
}

extern "C" int fs_paged_attention_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* context_lens, void* out,
    void* workspace, int B, int Hq, int Hkv, int D, int bs, int nb,
    int n_pages, int n_pages_padded, int n_splits, int chunk, float scale,
    void* stream) {
  return paged_attention(true, q, k_pool, v_pool, block_tables,
                         context_lens, out, workspace, B, Hq, Hkv, D, bs, nb,
                         n_pages, n_pages_padded, n_splits, chunk, scale,
                         stream);
}
