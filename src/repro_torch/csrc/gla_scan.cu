// Chunked gated linear attention with a scalar per-step decay (the Mamba2 /
// SSD scan), fp32 or bf16 in, fp32 state and accumulation.
//
// Replaces the Pallas TPU kernel repro/kernels/gla_scan.py
// (gla_scan_scalar -> pallas_call, body _kernel).  Per (batch, head), over
// chunks of C steps with L the inclusive cumsum of logw inside the chunk:
//
//     y      = (q * exp(L)) @ S  +  tril((q @ k^T) * exp(min(L_i - L_j, 0))) @ v
//     S_next = exp(L_C) * S + (k * exp(L_C - L))^T @ v
//
// What bounds it on the card: HBM bytes.  q, k, v and logw are read once, y
// and the final state written once: 238.6 MB at zamba2-7b's shape (B 1, H
// 112, T 4096, N = P = C = 64, bf16), 0.0712 ms at 3.35 TB/s (published H100
// SXM peak at 700 W; chip_smoke.py computes the bound from its inputs).  The
// work is ~64 flops a byte there, under the H100's ~295 flop/byte bf16
// ridge, but the chunks of one head form a serial chain, so the design
// spreads the heads over the card and shortens each chunk's step:
//
//   * One CTA of 16 warps per (batch, head) and slice of up to 64 columns
//     of P (mma_pt: 64, 32 or 16, as shared memory allows): 112 CTAs, one
//     wave, at zamba2-7b's shape, each reading its q and k once.
//   * A 3-stage ring of chunk tiles (q and k C x N, the v slice C x pt,
//     logw C), filled two chunks ahead by the Tensor Memory Accelerator:
//     one thread issues a 2-D tensor-map copy a tile and a bulk copy of
//     logw, counted on the stage's mbarrier; the maps' swizzle is the XOR
//     of each 16-byte chunk with its row that keeps ldmatrix free of bank
//     conflicts.  (cp.async copies from every thread held every warp for
//     much of each chunk step: an SM keeps few copies in flight.)  Shapes the
//     maps cannot describe (N not 16, 32 or 64; P not a multiple of 8) take
//     zero-filling cp.async copies.  N is padded to 16, 32, 64 or 128 (one
//     kernel instance each, its k loops unrolled) and the chunk to a
//     multiple of 16.  211,480 bytes of shared memory at that shape.
//   * One barrier a chunk, and two roles.  Warps 0-7 compute y:
//       y^T  = exp(L) (S^T q^T) + V^T A^T               (M p, N i)
//     one unit a 16-row tile of the chunk by two 16-wide P slices, which
//     share q's and A's fragments; the row tiles are dealt from both ends
//     of the chunk, so that the two y warps of an SM sub-partition get about
//     the same number of causal steps.  Warps 8-15 update the state,
//       S^T <- exp(L_C) S^T + V_w^T k                    (M p, N n)
//     one unit a P slice by two 16-wide column groups of S^T, which share
//     V_w's fragments; the fp32 accumulators stay in the warp's registers
//     for the whole walk and are written to global memory once.  The
//     chunk's product V_w^T k is summed in its own accumulator and added
//     to the decayed state once, as the plain version does (accumulating
//     onto the state lost bits at no decay); the new state goes to shared
//     memory as bf16 terms for the next chunk's S^T q^T.  Then the state
//     warps make, a chunk ahead, what does not depend on the state, as bf16
//     terms in double-buffered shared memory: L by a warp scan (warp 8 keeps
//     exp(L)); A = q k^T decayed and masked, one causal 16 x 16 tile a unit
//     (the decay by the SFU's ex2, the mask by selects on the diagonal
//     tile; A's accumulators, with the chunk's rows on M, are already laid
//     out as the B fragments of V^T A^T); V_w = v * exp(L_C - L), one
//     16-row step of one P slice a unit.  Both roles take about as long.
//     All products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 accumulate), transposed so that P is the M dimension.
//   * Precision.  q, k and v are exact in bf16.  A, S and V_w are fp32 and
//     each goes in as three bf16 terms (hi, then the residues: 24 bits), the
//     smallest first.  One term of any of them fails the repo's gates; two
//     of A pass them but flip ~0.2 % of y's bf16 roundings against fp32
//     operands (tests/test_torch_kernel_ops.py emulates the decomposition
//     on the CPU).
//   * y leaves the registers transposed back by movmatrix, as bf16 pairs.
//   * Deterministic: no atomics, a fixed order of every sum.
// Where the time goes: scripts/gla_scan_probe.py times variants of this
// kernel and clocks each phase of a chunk step on the card (PERF.md).
// fp32 inputs and shapes past this kernel (N above 128, chunk above 64)
// take a second kernel, one CTA per (batch, head) and 16 columns of P, with
// its products on the fp32 pipes from shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;           // the mma kernel's CTA
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;           // the mma kernel's ring of chunk tiles
constexpr int kMaxN = 128;           // N, padded to 16, the mma kernel takes
constexpr int kMaxC = 64;            // the chunk, padded to 16
constexpr int kMaxSmem = 232448;     // shared memory a block may use (H100)
constexpr int kTermsA = 3;           // bf16 terms of A, S^T and V_w
constexpr int kTermsS = 3;
constexpr int kTermsW = 3;
constexpr int kFmaPt = 16;           // P columns per CTA of the fp32 kernel
constexpr int kFmaThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// A row-major bf16 tile of NC 16-byte chunks a row in shared memory (NC a
// power of two): chunk c of row r sits at chunk r * NC + (c ^ f(r)), with
// f(r) chosen so that the 8 rows an ldmatrix phase reads at one logical
// chunk land in 8 distinct bank groups (r & 7 for rows of 8 or more chunks,
// (r >> 1) & 3 for 4, (r >> 2) & 1 for 2).
template <int NC>
struct Tile {
  static constexpr int kXs = NC >= 8 ? 0 : (NC == 4 ? 1 : 2);
  static constexpr int kXm = NC >= 8 ? 7 : NC - 1;
  uint32_t base;
  __device__ __forceinline__ uint32_t at(int r, int c) const {
    return base + (uint32_t)(r * NC + (c ^ ((r >> kXs) & kXm))) * 16u;
  }
};

// The same with NC known at run time.
struct TileR {
  uint32_t base;
  int nc, xs, xm;
  __device__ __forceinline__ uint32_t at(int r, int c) const {
    return base + (uint32_t)(r * nc + (c ^ ((r >> xs) & xm))) * 16u;
  }
};
__device__ __forceinline__ TileR tile_r(uint32_t base, int nc) {
  return TileR{base, nc, nc >= 8 ? 0 : (nc == 4 ? 1 : 2),
               nc >= 8 ? 7 : nc - 1};
}

// N padded for the mma kernel: 16 times a power of two (16, 32, 64, 128).
__host__ __device__ inline int mma_pad_n(int N) {
  int np = 16;
  while (np < N) np *= 2;
  return np;
}

// Byte offsets of the mma kernel's shared memory for a P slice of pt
// columns (kernels/gla_scan.py's launch_plan repeats it), from a base
// aligned to 1 KB: kStages stages of q, k, the v slice and logw (each tile
// 1 KB aligned, as the copy engine's swizzle needs); two buffers each of
// S^T's, V_w's and A's bf16 terms; each warp's L; two rows of exp(L); one
// mbarrier a stage.
struct Layout {
  int k_off, v_off, lw_off, stage, sterms, vw, aterms, lpriv, arrays, mbar,
      total;
};
__host__ __device__ inline int align1k(int bytes) {
  return (bytes + 1023) / 1024 * 1024;
}
__host__ __device__ inline Layout mma_layout(int N, int C, int pt) {
  const int Np = mma_pad_n(N);
  const int Cp = (C + 15) / 16 * 16;
  const int MT = Cp / 16;
  Layout l;
  l.k_off = align1k(Cp * Np * 2);
  l.v_off = 2 * l.k_off;
  l.lw_off = l.v_off + align1k(Cp * pt * 2);
  l.stage = align1k(l.lw_off + Cp * 4);
  l.sterms = kStages * l.stage;
  l.vw = l.sterms + 2 * kTermsS * pt * Np * 2;
  l.aterms = l.vw + 2 * kTermsW * Cp * pt * 2;
  l.lpriv = l.aterms + 2 * MT * (MT + 1) / 2 * kTermsA * 512;
  l.arrays = l.lpriv + kWarps * Cp * 4;
  l.mbar = l.arrays + 2 * Cp * 4;
  l.total = l.mbar + kStages * 8 + 1024;   // + aligning the base to 1 KB
  return l;
}

// The P slice of one mma CTA: 64, 32 or 16 columns, no wider than P needs
// and with its tiles within the shared memory a block may use.
inline int mma_pt(int N, int P, int C) {
  int pt = 64;
  while (pt > 16 &&
         (pt / 2 >= P || mma_layout(N, C, pt).total > kMaxSmem)) {
    pt /= 2;
  }
  return pt;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 8 bytes global -> shared, zero-filled where `valid` is false.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The Tensor Memory Accelerator: a bulk copy of `bytes` (a multiple of 16,
// both addresses 16-byte aligned) or a 2-D tile of a tensor map, global ->
// shared, their arrival counted on an mbarrier that expects the stage's
// bytes.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes));
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity));
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(x));
}
__device__ __forceinline__ void sts_u128(uint32_t addr, uint4 x) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w));
}
__device__ __forceinline__ uint4 lds_u128(uint32_t addr) {
  uint4 x;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "r"(addr));
  return x;
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
__device__ __forceinline__ float2 bf16x2_to_f2(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// (x0, x1) as NT bf16 pairs: hi = bf16(x), then bf16 of each residue (exact
// in fp32), so that three terms carry the 24 bits of each fp32 value.
template <int NT>
__device__ __forceinline__ void split_bf16(float x0, float x1,
                                           uint32_t (&parts)[NT]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    parts[i] = as_u32(h);
    if (i + 1 < NT) {
      const float2 hf = __bfloat1622float2(h);
      x0 -= hf.x;
      x1 -= hf.y;
    }
  }
}

// Inclusive cumsum of x[0, n) into out[0, n) by one warp (x may be out):
// each lane sums a contiguous segment in order, the lanes' totals are
// scanned by shuffles.  Returns out[n - 1] on every lane.
__device__ float warp_cumsum(const float* x, float* out, int n, int lane) {
  const int seg = (n + 31) / 32;
  const int a = min(lane * seg, n);
  const int e = min(a + seg, n);
  float run = 0.f;
  for (int j = a; j < e; ++j) run += x[j];
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  float acc = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) acc = 0.f;
  for (int j = a; j < e; ++j) {
    acc += x[j];
    out[j] = acc;
  }
  return __shfl_sync(kFull, acc, (n - 1) / seg);
}

// The same for n a multiple of 16 up to 128, in registers and without
// loops: lane l returns out[4l, 4l + 4) in `mine` (zeros past n read as
// zeros); every lane gets the total, out[n - 1].
__device__ __forceinline__ float warp_cumsum128(const float* x, int n,
                                                int lane, float4& mine) {
  float4 a = 4 * lane < n ? *reinterpret_cast<const float4*>(x + 4 * lane)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  float incl = ((a.x + a.y) + a.z) + a.w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  float acc = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) acc = 0.f;
  a.x += acc;
  a.y += a.x;
  a.z += a.y;
  a.w += a.z;
  mine = a;
  return __shfl_sync(kFull, a.w, (n - 1) / 4);
}

// e^min(d, 0) by the SFU's ex2 (about 2 ulp; exactly 1 at 0, and results
// below 2^-126 flushed to 0).
__device__ __forceinline__ float fast_exp_min0(float d) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(fminf(d, 0.f) * kLog2e));
  return r;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.  NK = Np / 16 k16 steps over the padded N.
// ---------------------------------------------------------------------------
template <int NK>
__global__ void __launch_bounds__(kThreads, 1)
gla_scan_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ logw,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ s_out,
                    int Tn, int N, int P, int C, int pt, int n_ps, int tma,
                    const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v) {
  constexpr int NC = 2 * NK;               // 16-byte chunks of a q / k row
  constexpr int kUnitsS = NK == 8 ? 2 : 1;   // state units a warp keeps
  extern __shared__ uint4 smem[];
  const Layout lay = mma_layout(N, C, pt);
  const uint32_t sbase = (smem_u32(smem) + 1023u) & ~1023u;
  char* smem_c = reinterpret_cast<char*>(smem) + (sbase - smem_u32(smem));

  const int bh = blockIdx.x / n_ps;
  const int p0 = (blockIdx.x % n_ps) * pt;
  const int PS = (min(pt, P - p0) + 15) / 16;   // 16-wide P slices here
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;                 // fragment row (and row + 8)
  const int t4 = lane % 4;                 // fragment column pair
  const int Cp = (C + 15) / 16 * 16;
  const int MT = Cp / 16;                  // 16-row tiles of the chunk
  const int n_tiles = MT * (MT + 1) / 2;   // causal (row, column) tiles
  const int ncv = pt / 8;                  // 16-byte chunks of a v row
  const int n_chunks = Tn / C;
  // Warps 0-7 compute y, warps 8-15 the state, side by side.  A state
  // unit is 16 rows (p) of one P slice by the 32 columns (n) of two column
  // groups: u = warp - 8 + 8 * gi is group pair u % GP of slice u / GP.
  const int GP = (NK + 1) / 2;             // column-group pairs
  const bool state_warp = warp >= kWarps / 2;
  const int sw = warp - kWarps / 2;

  float* wl = reinterpret_cast<float*>(smem_c + lay.lpriv) + warp * Cp;

  const __nv_bfloat16* qb = q + (size_t)bh * Tn * N;
  const __nv_bfloat16* kb = k + (size_t)bh * Tn * N;
  const __nv_bfloat16* vb = v + (size_t)bh * Tn * P;
  const float* lb = logw + (size_t)bh * Tn;

  auto stage = [&](int c) { return sbase + (c % kStages) * lay.stage; };
  auto q_tile = [&](int c) { return Tile<NC>{stage(c)}; };
  auto k_tile = [&](int c) { return Tile<NC>{stage(c) + (uint32_t)lay.k_off}; };
  auto v_tile = [&](int c) {
    return tile_r(stage(c) + (uint32_t)lay.v_off, ncv);
  };
  auto mbar = [&](int c) {
    return sbase + (uint32_t)lay.mbar + (uint32_t)(c % kStages) * 8u;
  };
  // the copy engine's tiles where the host made tensor maps, else
  // zero-filling cp.async copies of 8 or 16 bytes
  const bool use_tma = tma != 0;
  // bf16 terms in shared memory, double-buffered by chunk parity: the
  // state after the chunk before (S^T, pt x Np), V_w (Cp x pt) and A's
  // causal 16 x 16 tiles
  auto s_terms = [&](int buf, int t) {
    return Tile<NC>{sbase + (uint32_t)lay.sterms +
                    (uint32_t)((buf * kTermsS + t) * pt * NC * 16)};
  };
  auto vw_terms = [&](int buf, int t) {
    return tile_r(sbase + (uint32_t)lay.vw +
                      (uint32_t)((buf * kTermsW + t) * Cp * pt * 2),
                  ncv);
  };
  auto a_terms = [&](int buf, int tile, int t) {
    return Tile<2>{sbase + (uint32_t)lay.aterms +
                   (uint32_t)(((buf * n_tiles + tile) * kTermsA + t) * 512)};
  };
  auto e_row = [&](int buf) {              // exp(L)
    return reinterpret_cast<float*>(smem_c + lay.arrays) + buf * Cp;
  };

  // chunk c's tiles into ring stage c % kStages.  The copy engine: one
  // thread issues a 2-D copy a tile (rows past C were zeroed once, columns
  // past P are zero-filled by the engine); else every thread, zero-filling
  // rows past C and columns past N (or P).
  auto load = [&](int c) {
    if (c < n_chunks) {
      const Tile<NC> tq = q_tile(c);
      const Tile<NC> tk = k_tile(c);
      const TileR tv = v_tile(c);
      const size_t t0 = (size_t)c * C;
      if (use_tma) {
        if (tid == kThreads - 32) {
          const uint32_t bar = mbar(c);
          const int row = (int)((size_t)bh * Tn + t0);
          fence_proxy_async();
          mbar_expect_tx(bar, C * (4 * N + 2 * pt + 4));
          tma_2d(tq.base, &tm_q, 0, row, bar);
          tma_2d(tk.base, &tm_k, 0, row, bar);
          tma_2d(tv.base, &tm_v, p0, row, bar);
          bulk_copy(stage(c) + lay.lw_off, lb + t0, 4 * C, bar);
        }
        return;
      }
      if (N % 8 == 0) {                    // a fixed column, rows apart
        const int ch = tid % NC;
        const __nv_bfloat16* qs = qb + t0 * N + ch * 8;
        const __nv_bfloat16* ks = kb + t0 * N + ch * 8;
        for (int r = tid / NC; r < Cp; r += kThreads / NC) {
          const bool ok = r < C && ch * 8 < N;
          cp_async16(tq.at(r, ch), ok ? qs + r * N : qb, ok);
          cp_async16(tk.at(r, ch), ok ? ks + r * N : kb, ok);
        }
      } else {                             // rows of 8-byte multiples
        for (int x = tid; x < Cp * NC * 2; x += kThreads) {
          const int r = x / (2 * NC);
          const int h = x % (2 * NC);
          const bool ok = r < C && h * 4 < N;
          const size_t off = ok ? (t0 + r) * N + h * 4 : 0;
          cp_async8(tq.at(r, h / 2) + (h & 1) * 8, qb + off, ok);
          cp_async8(tk.at(r, h / 2) + (h & 1) * 8, kb + off, ok);
        }
      }
      if (P % 8 == 0) {
        for (int x = tid; x < Cp * ncv; x += kThreads) {
          const int r = x / ncv;
          const int ch = x % ncv;
          const bool ok = r < C && p0 + ch * 8 < P;
          const size_t off = ok ? (t0 + r) * P + p0 + ch * 8 : 0;
          cp_async16(tv.at(r, ch), vb + off, ok);
        }
      } else {
        for (int x = tid; x < Cp * ncv * 2; x += kThreads) {
          const int r = x / (2 * ncv);
          const int h = x % (2 * ncv);
          const bool ok = r < C && p0 + h * 4 < P;
          const size_t off = ok ? (t0 + r) * P + p0 + h * 4 : 0;
          cp_async8(tv.at(r, h / 2) + (h & 1) * 8, vb + off, ok);
        }
      }
      for (int x = tid; x < Cp / 4; x += kThreads) {
        const bool ok = x * 4 < C;
        cp_async16(stage(c) + lay.lw_off + x * 16,
                   lb + (ok ? t0 + x * 4 : 0), ok);
      }
    }
    if (!use_tma) cp_async_commit();
  };
  // waits until chunk c's tiles have landed (the copy engine's, counted on
  // the stage's mbarrier; or this thread's cp.async groups, the most recent
  // of which may stay in flight when `keep_one`)
  auto wait_chunk = [&](int c, bool keep_one) {
    if (use_tma) {
      if (c < n_chunks) mbar_wait(mbar(c), (c / kStages) & 1);
    } else if (keep_one) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
  };

  // The products of chunk c that do not depend on the state, made one
  // chunk ahead by the state warps (the y warps have the longer products)
  // as bf16 terms in buffer c & 1: each scans the chunk's logw for L into
  // its own copy (warp 8 keeps exp(L)); A = q k^T decayed and masked, one
  // causal 16 x 16 tile a unit; V_w = v * exp(L_C - L), one 16-row step of
  // one P slice a unit.  Returns L_C.
  auto prep = [&](int c) -> float {
    const int buf = c & 1;
    const Tile<NC> tq = q_tile(c);
    const Tile<NC> tk = k_tile(c);
    const TileR tv = v_tile(c);
    const float* lw = reinterpret_cast<const float*>(
        smem_c + (c % kStages) * lay.stage + lay.lw_off);
    // L over the padded chunk (logw is zero past C, so the pads repeat L_C)
    float4 Lq;
    const float l_c = warp_cumsum128(lw, Cp, lane, Lq);
    if (4 * lane < Cp) {
      *reinterpret_cast<float4*>(wl + 4 * lane) = Lq;
      if (sw == 0) {
        *reinterpret_cast<float4*>(e_row(buf) + 4 * lane) =
            make_float4(expf(Lq.x), expf(Lq.y), expf(Lq.z), expf(Lq.w));
      }
    }
    __syncwarp();
    for (int u = sw; u < n_tiles; u += kWarps / 2) {   // A's tiles
      int mt = 0;
      while ((mt + 1) * (mt + 2) / 2 <= u) ++mt;
      const int js = u - mt * (mt + 1) / 2;
      const int i0 = mt * 16;
      const int j0 = js * 16;
      float acc[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        uint32_t qf[4], kf[4];
        ldsm_x4(tq.at(i0 + (lane & 15), 2 * ks + (lane >> 4)), qf);
        ldsm_x4(tk.at(j0 + (lane & 7) + ((lane >> 4) << 3),
                      2 * ks + ((lane >> 3) & 1)),
                kf);
        mma_bf16(acc[0], qf, kf[0], kf[1]);
        mma_bf16(acc[1], qf, kf[2], kf[3]);
      }
      // acc[h][e]: row i0 + gq (+ 8 for e >= 2), column j0 + 8h + 2t4 + e%2;
      // the causal mask (a select) on the diagonal tile only.  Row i and
      // column j of the tile are the B fragment layout of V^T A^T (k j, n i)
      const bool diag = js == mt;
      const float la = wl[i0 + gq];
      const float lb8 = wl[i0 + gq + 8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jr = 8 * h + 2 * t4;     // column within the tile
        const float2 lj = *reinterpret_cast<const float2*>(wl + j0 + jr);
        const float f0 = fast_exp_min0(la - lj.x);
        const float f1 = fast_exp_min0(la - lj.y);
        const float f2 = fast_exp_min0(lb8 - lj.x);
        const float f3 = fast_exp_min0(lb8 - lj.y);
        acc[h][0] *= !diag || jr <= gq ? f0 : 0.f;
        acc[h][1] *= !diag || jr + 1 <= gq ? f1 : 0.f;
        acc[h][2] *= !diag || jr <= gq + 8 ? f2 : 0.f;
        acc[h][3] *= !diag || jr + 1 <= gq + 8 ? f3 : 0.f;
        uint32_t lo[kTermsA], hi[kTermsA];
        split_bf16<kTermsA>(acc[h][0], acc[h][1], lo);
        split_bf16<kTermsA>(acc[h][2], acc[h][3], hi);
#pragma unroll
        for (int t = 0; t < kTermsA; ++t) {
          sts_u32(a_terms(buf, u, t).at(gq, h) + 4 * t4, lo[t]);
          sts_u32(a_terms(buf, u, t).at(gq + 8, h) + 4 * t4, hi[t]);
        }
      }
    }
    // V_w's blocks, the warps with one tile of A fewer first; lane l takes
    // row j0 + l / 2, eight columns
    const int v_rank = (sw + kWarps / 2 - n_tiles % (kWarps / 2)) %
                       (kWarps / 2);
    for (int u = v_rank; u < MT * PS; u += kWarps / 2) {
      const int j = (u % MT) * 16 + (lane >> 1);
      const int ch = 2 * (u / MT) + (lane & 1);
      const float wj = expf(l_c - wl[j]);
      const uint4 raw = lds_u128(tv.at(j, ch));
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t parts[4][kTermsW];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = bf16x2_to_f2(in[r]);
        split_bf16<kTermsW>(f.x * wj, f.y * wj, parts[r]);
      }
#pragma unroll
      for (int t = 0; t < kTermsW; ++t) {
        sts_u128(vw_terms(buf, t).at(j, ch),
                 make_uint4(parts[0][t], parts[1][t], parts[2][t],
                            parts[3][t]));
      }
    }
    return l_c;
  };

  // the state units' fp32 accumulators, in registers for the whole walk
  float sacc[kUnitsS][2][2][4];
#pragma unroll
  for (int gi = 0; gi < kUnitsS; ++gi) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[gi][b][h][e] = 0.f;
      }
    }
  }

  if (use_tma) {       // zero the stages' padding; one mbarrier a stage
    for (int x = tid; x < kStages * lay.stage / 16; x += kThreads) {
      sts_u128(sbase + 16u * x, make_uint4(0u, 0u, 0u, 0u));
    }
    if (tid < kStages) mbar_init(mbar(tid));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
  }
  load(0);
  load(1);
  wait_chunk(0, true);
  __syncthreads();     // chunk 0 landed
  float l_next = state_warp ? prep(0) : 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    wait_chunk(c + 1, false);
    __syncthreads();   // chunk c + 1 landed; chunk c's terms and the state
                       // after chunk c - 1 are shared; chunk c - 1 is done
    load(c + 2);       // into the stage chunk c - 1 used
    const int buf = c & 1;
    const float l_c = l_next;
    const Tile<NC> tk = k_tile(c);
    const TileR tv = v_tile(c);
    if (!state_warp) {
      // y, one (16-row tile, pair of P slices) unit at a time:
      //   y^T = exp(L) (S^T q^T) + V^T A^T
      // the two slices share q's and A's fragments.  Row tiles are dealt
      // from both ends of the chunk, so that warps w and w + 4 (one SM
      // sub-partition) get about the same number of causal column steps.
      const Tile<NC> tq = q_tile(c);
      const float* eL = e_row(buf);
      const int SP = (PS + 1) / 2;
      for (int u = warp; u < MT * SP; u += kWarps / 2) {
        const int nat = u / SP;
        const int mt = nat < MT / 2 ? nat : MT - 1 - (nat - MT / 2);
        const int ps0 = 2 * (u % SP);
        const bool two = ps0 + 1 < PS;
        const int i0 = mt * 16;
        float yo[2][2][4], yi[2][2][4];    // inter and intra, per slice
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 4; ++e) yo[b][h][e] = yi[b][h][e] = 0.f;
          }
        }
        if (c > 0) {
#pragma unroll
          for (int ks = 0; ks < NK; ++ks) {
            uint32_t qt[4];                // B of S^T q^T: (k n, n i)
            ldsm_x4(tq.at(i0 + (lane & 7) + ((lane >> 4) << 3),
                          2 * ks + ((lane >> 3) & 1)),
                    qt);
#pragma unroll
            for (int t = kTermsS - 1; t >= 0; --t) {
#pragma unroll
              for (int b = 0; b < 2; ++b) {
                if (b == 1 && !two) continue;
                uint32_t sf[4];
                ldsm_x4(s_terms(buf, t).at(16 * (ps0 + b) + (lane & 15),
                                           2 * ks + (lane >> 4)),
                        sf);
                mma_bf16(yo[b][0], sf, qt[0], qt[1]);
                mma_bf16(yo[b][1], sf, qt[2], qt[3]);
              }
            }
          }
        }
        // intra over the causal column steps js <= mt, A's terms smallest
        // first
#pragma unroll 1
        for (int js = 0; js <= mt; ++js) {
          const int j0 = js * 16;
          uint32_t va[2][4];               // V^T (16 p x 16 j) per slice
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            if (b == 1 && !two) continue;
            ldsm_x4_trans(tv.at(j0 + (lane & 7) + ((lane >> 4) << 3),
                                2 * (ps0 + b) + ((lane >> 3) & 1)),
                          va[b]);
          }
          const int tile = mt * (mt + 1) / 2 + js;
#pragma unroll
          for (int t = kTermsA - 1; t >= 0; --t) {
            uint32_t af[4];
            ldsm_x4(a_terms(buf, tile, t).at((lane & 7) + ((lane >> 4) << 3),
                                             (lane >> 3) & 1),
                    af);
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              if (b == 1 && !two) continue;
              mma_bf16(yi[b][0], va[b], af[0], af[1]);
              mma_bf16(yi[b][1], va[b], af[2], af[3]);
            }
          }
        }
        // y^T[p][i] = exp(L_i) inter + intra; transposed back to rows of y
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if (b == 1 && !two) continue;
          const int pc = p0 + 16 * (ps0 + b) + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* so = yo[b][h];
            const float2 ei =
                *reinterpret_cast<const float2*>(eL + i0 + 8 * h + 2 * t4);
            const uint32_t lo = movmatrix_trans(as_u32(__floats2bfloat162_rn(
                fmaf(so[0], ei.x, yi[b][h][0]),
                fmaf(so[1], ei.y, yi[b][h][1]))));
            const uint32_t hi = movmatrix_trans(as_u32(__floats2bfloat162_rn(
                fmaf(so[2], ei.x, yi[b][h][2]),
                fmaf(so[3], ei.y, yi[b][h][3]))));
            const int i = i0 + 8 * h + gq;   // lo: p pc, pc + 1; hi: p + 8
            if (i < C) {
              __nv_bfloat16* row =
                  y + ((size_t)bh * Tn + (size_t)c * C + i) * P;
              if (pc < P) *reinterpret_cast<uint32_t*>(row + pc) = lo;
              if (pc + 8 < P) {
                *reinterpret_cast<uint32_t*>(row + pc + 8) = hi;
              }
            }
          }
        }
      }
    } else {
      // S^T <- exp(L_C) S^T + V_w^T k for this warp's units: the chunk's
      // product in its own accumulators, then added to the decayed state
      // once (as the plain version adds them); the two column groups share
      // V_w's fragments.  Then the new state's terms, for the next chunk.
      const float dec = expf(l_c);
#pragma unroll
      for (int gi = 0; gi < kUnitsS; ++gi) {
        const int u = sw + kWarps / 2 * gi;
        if (u >= GP * PS) continue;
        const int g0 = 2 * (u % GP);
        const int ps = u / GP;
        const bool two = g0 + 1 < NK;
        float part[2][2][4];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 4; ++e) part[b][h][e] = 0.f;
          }
        }
#pragma unroll 1
        for (int js = 0; js < MT; ++js) {
          const int j0 = js * 16;
          uint32_t kf[2][4];               // k (j x n) as B: (k j, n n)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            if (b == 1 && !two) continue;
            ldsm_x4_trans(tk.at(j0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                2 * (g0 + b) + (lane >> 4)),
                          kf[b]);
          }
#pragma unroll
          for (int t = kTermsW - 1; t >= 0; --t) {
            uint32_t a[4];                 // V_w^T (16 p x 16 j), term t
            ldsm_x4_trans(
                vw_terms(buf, t).at(j0 + (lane & 7) + ((lane >> 4) << 3),
                                    2 * ps + ((lane >> 3) & 1)),
                a);
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              if (b == 1 && !two) continue;
              mma_bf16(part[b][0], a, kf[b][0], kf[b][1]);
              mma_bf16(part[b][1], a, kf[b][2], kf[b][3]);
            }
          }
        }
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if (b == 1 && !two) continue;
          const int g = g0 + b;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sacc[gi][b][h][e] = fmaf(dec, sacc[gi][b][h][e], part[b][h][e]);
            }
            if (c + 1 < n_chunks) {
              uint32_t lo[kTermsS], hi[kTermsS];
              split_bf16<kTermsS>(sacc[gi][b][h][0], sacc[gi][b][h][1], lo);
              split_bf16<kTermsS>(sacc[gi][b][h][2], sacc[gi][b][h][3], hi);
#pragma unroll
              for (int t = 0; t < kTermsS; ++t) {
                const Tile<NC> tt = s_terms(buf ^ 1, t);
                sts_u32(tt.at(16 * ps + gq, 2 * g + h) + 4 * t4, lo[t]);
                sts_u32(tt.at(16 * ps + gq + 8, 2 * g + h) + 4 * t4, hi[t]);
              }
            }
          }
        }
      }
    }
    if (state_warp && c + 1 < n_chunks) l_next = prep(c + 1);
  }

  // the final state: S[n][p] = S^T[p][n]
  if (state_warp) {
#pragma unroll
    for (int gi = 0; gi < kUnitsS; ++gi) {
      const int u = sw + kWarps / 2 * gi;
      if (u >= GP * PS) continue;
      const int pr = p0 + 16 * (u / GP);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int g = 2 * (u % GP) + b;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = pr + gq + 8 * (e >> 1);
            const int n = 16 * g + 8 * h + 2 * t4 + (e & 1);
            if (g < NK && n < N && p < P) {
              s_out[((size_t)bh * N + n) * P + p] = sacc[gi][b][h][e];
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 pipes: fp32 inputs, and bf16 shapes past the mma kernel's N or C.
// ---------------------------------------------------------------------------
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

// Shared memory of the fp32-pipe kernel (kernels/gla_scan.py repeats it).
__host__ __device__ inline size_t fma_smem_bytes(int N, int P, int C) {
  const size_t pw = P < kFmaPt ? P : kFmaPt;
  return sizeof(float) * ((size_t)C * N + (size_t)N * (C + 4) + C * pw +
                          (size_t)C * C + N * pw + 2 * (size_t)C);
}

// One CTA per ((batch, head), 16-wide slice of P), walking the chunks in
// order with the slice's N x Pw state in shared memory; per chunk q, k
// (transposed), the v slice, the decayed scores A and L staged as fp32, each
// thread computing 4 neighbouring outputs of a product from one broadcast
// scalar and one float4 per step of the inner sum.
template <typename T>
__global__ void __launch_bounds__(kFmaThreads)
gla_scan_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ logw,
                    T* __restrict__ y, float* __restrict__ s_out, int Tn,
                    int N, int P, int C, int n_ps) {
  const int KS = C + 4;                  // row stride of the transposed k
  const int PW = P < kFmaPt ? P : kFmaPt;      // the slice buffers' width
  const int bh = blockIdx.x / n_ps;
  const int p0 = (blockIdx.x % n_ps) * kFmaPt;
  const int Pw = min(kFmaPt, P - p0);   // this slice's width, a multiple of 4
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);   // C x N
  float* skT = sq + C * N;                       // N x KS
  float* sv = skT + N * KS;                      // C x Pw
  float* sA = sv + C * PW;                       // C x C
  float* sS = sA + C * C;                        // N x Pw, the carried state
  float* sL = sS + N * PW;                       // C, inclusive cumsum
  float* sW = sL + C;                            // C, exp(L_C - L_i)

  const T* qb = q + (size_t)bh * Tn * N;
  const T* kb = k + (size_t)bh * Tn * N;
  const T* vb = v + (size_t)bh * Tn * P + p0;
  const float* lb = logw + (size_t)bh * Tn;
  T* yb = y + (size_t)bh * Tn * P + p0;
  const int tid = threadIdx.x;
  const int C4 = C / 4;
  const int P4 = Pw / 4;

  for (int x = tid; x < N * Pw; x += kFmaThreads) sS[x] = 0.f;

  for (int c0 = 0; c0 < Tn; c0 += C) {
    __syncthreads();   // the previous chunk's reads are done
    for (int x = tid; x < C * N; x += kFmaThreads) {
      const int i = x / N;
      const int n = x % N;
      sq[x] = to_f32(qb[(size_t)c0 * N + x]);
      skT[n * KS + i] = to_f32(kb[(size_t)c0 * N + x]);
    }
    for (int x = tid; x < C * Pw; x += kFmaThreads) {
      const int i = x / Pw;
      sv[x] = to_f32(vb[(size_t)(c0 + i) * P + x % Pw]);
    }
    for (int x = tid; x < C; x += kFmaThreads) sL[x] = lb[c0 + x];
    __syncthreads();
    if (tid < 32) warp_cumsum(sL, sL, C, tid);
    __syncthreads();
    for (int x = tid; x < C; x += kFmaThreads) sW[x] = expf(sL[C - 1] - sL[x]);

    // A[i][j] = (q_i . k_j) * exp(min(L_i - L_j, 0)) for j <= i, else 0
    for (int x = tid; x < C * C4; x += kFmaThreads) {
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
    for (int x = tid; x < C * P4; x += kFmaThreads) {
      const int i = x / P4;
      const int p = (x % P4) * 4;
      float4 inter = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int n = 0; n < N; ++n) {
        fma4(sq[i * N + n], *reinterpret_cast<const float4*>(sS + n * Pw + p),
             inter);
      }
      const float dec = expf(sL[i]);
      float4 o = make_float4(dec * inter.x, dec * inter.y, dec * inter.z,
                             dec * inter.w);
      for (int j = 0; j <= i; ++j) {
        fma4(sA[i * C + j], *reinterpret_cast<const float4*>(sv + j * Pw + p),
             o);
      }
      T* yp = yb + (size_t)(c0 + i) * P + p;
      store(yp + 0, o.x);
      store(yp + 1, o.y);
      store(yp + 2, o.z);
      store(yp + 3, o.w);
    }
    __syncthreads();   // every read of the old S is done

    // S = exp(L_C) * S + sum_i (k_i * exp(L_C - L_i)) v_i^T
    const float decay = expf(sL[C - 1]);
    for (int x = tid; x < N * P4; x += kFmaThreads) {
      const int n = x / P4;
      const int p = (x % P4) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = 0; i < C; ++i) {
        fma4(skT[n * KS + i] * sW[i],
             *reinterpret_cast<const float4*>(sv + i * Pw + p), a);
      }
      float4* sp = reinterpret_cast<float4*>(sS + n * Pw + p);
      const float4 old = *sp;
      *sp = make_float4(decay * old.x + a.x, decay * old.y + a.y,
                        decay * old.z + a.z, decay * old.w + a.w);
    }
  }
  __syncthreads();
  float* so = s_out + (size_t)bh * N * P + p0;
  for (int x = tid; x < N * Pw; x += kFmaThreads) {
    so[(size_t)(x / Pw) * P + x % Pw] = sS[x];
  }
}

// Allow `bytes` of dynamic shared memory, with the SM's unified L1 /
// shared memory carved out for shared memory, so that as many CTAs as fit
// are resident.
template <typename K>
int set_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  return (int)err;
}

template <typename T>
int launch_fma(const void* q, const void* k, const void* v, const void* logw,
               void* y, void* s_out, int BH, int Tn, int N, int P, int C,
               int n_ps, cudaStream_t s) {
  const size_t bytes = fma_smem_bytes(N, P, C);
  const int err = set_smem(gla_scan_fma_kernel<T>, bytes);
  if (err != 0) return err;
  gla_scan_fma_kernel<T><<<BH * n_ps, kFmaThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<T*>(y), static_cast<float*>(s_out), Tn, N, P, C, n_ps);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled of the driver, found once through the runtime (so
// the library needs no link against libcuda); null where it is missing.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map over `rows` bf16 rows of `cols` elements, copied in boxes of
// box_rows x box_cols (16, 32 or 64) and swizzled as Tile<box_cols / 8>
// (with the box's 1 KB-aligned base); columns past `cols` arrive as zeros.
bool tile_map(CUtensorMap* map, const void* base, int cols, long long rows,
              int box_cols, int box_rows) {
  const CUtensorMapSwizzle swizzle =
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : (box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                       : CU_TENSOR_MAP_SWIZZLE_32B);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NK>
int launch_mma(const void* q, const void* k, const void* v, const void* logw,
               void* y, void* s_out, int BH, int Tn, int N, int P, int C,
               int pt, int n_ps, cudaStream_t s) {
  const size_t bytes = mma_layout(N, C, pt).total;
  const int err = set_smem(gla_scan_mma_kernel<NK>, bytes);
  if (err != 0) return err;
  // the copy engine's 2-D tiles where a row of q (and of the v slice) is
  // exactly one swizzle span and v's rows are 16-byte multiples
  const long long rows = (long long)BH * Tn;
  CUtensorMap mq{}, mk{}, mv{};
  const int tma = (N == 16 || N == 32 || N == 64) && P % 8 == 0 &&
                  rows < (1ll << 31) && encode_tiled() != nullptr &&
                  tile_map(&mq, q, N, rows, N, C) &&
                  tile_map(&mk, k, N, rows, N, C) &&
                  tile_map(&mv, v, P, rows, pt, C);
  gla_scan_mma_kernel<NK><<<BH * n_ps, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(logw),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(s_out), Tn, N, P,
      C, pt, n_ps, tma, mq, mk, mv);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k (BH, T, N), v (BH, T, P), y (BH, T, P): contiguous, 16-byte aligned,
// all fp32 (bf16 = 0) or all bf16 (bf16 = 1); logw (BH, T) and s_out (BH,
// N, P) fp32, logw 16-byte aligned.  N, P and C multiples of 4, T a
// multiple of C.  bf16 with N at most 128 and C at most 64 runs on the
// tensor cores, BH * ceil(P / pt) CTAs of 16 warps (pt from mma_pt); the
// rest on the fp32 pipes, BH * ceil(P / 16) CTAs.  Launches on ``stream``
// and returns the CUDA error code (0 = launched).
extern "C" int fs_gla_scan_scalar(const void* q, const void* k, const void* v,
                                  const void* logw, void* y, void* s_out,
                                  int BH, int Tn, int N, int P, int C,
                                  int bf16, void* stream) {
  const int n_ps = (P + kFmaPt - 1) / kFmaPt;
  if (BH <= 0 || Tn <= 0 || N <= 0 || P <= 0 || C <= 0 || N % 4 != 0 ||
      P % 4 != 0 || C % 4 != 0 || Tn % C != 0 ||
      (long long)BH * n_ps > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16 && N <= kMaxN && C <= kMaxC) {
    const int pt = mma_pt(N, P, C);
    const int m_ps = (P + pt - 1) / pt;
    switch (mma_pad_n(N)) {
      case 16:
        return launch_mma<1>(q, k, v, logw, y, s_out, BH, Tn, N, P, C, pt,
                             m_ps, s);
      case 32:
        return launch_mma<2>(q, k, v, logw, y, s_out, BH, Tn, N, P, C, pt,
                             m_ps, s);
      case 64:
        return launch_mma<4>(q, k, v, logw, y, s_out, BH, Tn, N, P, C, pt,
                             m_ps, s);
      default:
        return launch_mma<8>(q, k, v, logw, y, s_out, BH, Tn, N, P, C, pt,
                             m_ps, s);
    }
  }
  return bf16 ? launch_fma<__nv_bfloat16>(q, k, v, logw, y, s_out, BH, Tn, N,
                                          P, C, n_ps, s)
              : launch_fma<float>(q, k, v, logw, y, s_out, BH, Tn, N, P, C,
                                  n_ps, s);
}
