// The backward of flash attention on Hopper's tensor cores: causal and/or
// sliding-window grouped-query attention, q (B, H, S, D) against k, v
// (B, KH, T, D), query positions right-aligned at offset T - S, as the
// forward kernels compute it. From the forward's output O and row
// log-sum-exp lse (float32 (B, H, S)) and the output's gradient dO it gives
// dQ, dK and dV in the inputs' type (float32 or bf16), any D <= 256,
// accumulating in float32.
//
// Replaces no Pallas kernel: the TPU package trains through
// repro/kernels/ref.py::_ca_bwd (the custom VJP of chunked_attention, a jnp
// double scan), its one hand-written attention backward. The port's
// forward is a CUDA kernel whose output has no autograd graph, so the card
// needs this kernel for a gradient to reach q, k and v.
//
// The maths of _ca_bwd, without its chunking: delta = rowsum(dO * O),
// P = exp(S scale - lse), dV = P^T dO, dP = dO V^T, dS = P (dP - delta)
// scale, dQ = dS K, dK = dS^T Q; dK and dV sum the G query heads of a kv
// head. P and dS are rounded to the input type before the products that
// read them, as _ca_bwd rounds them (a no-op in float32).
//
// What bounds it on the H100: operations. Five products of 2 D flops for
// each (query, key) pair the masks let through; at gemma3-1b's training
// shape (4 rows of 1,024 tokens, 4 query heads on 1 kv head, D = 256,
// window 512) 16.1 GFLOP against ~40 MB of inputs and gradients. In bf16
// the bound is 989 TFLOP/s of the tensor cores; in float32 each product
// is three TF32 products (below), so 3 x flops / 494.7 TFLOP/s (67 TFLOP/s
// of float32 FMA is the bound of the same sums on the CUDA cores).
//
// What the design does:
//  * Two passes, one work list each, built by the wrapper
//    (kernels/flash_attention.py::backward_plan): the dK/dV pass keeps 64
//    keys of one (row, kv head) resident and streams blocks of 32 queries
//    of the kv head's G query heads; the dQ pass keeps 64 queries of one
//    (row, head) resident and streams blocks of keys. An entry of a list
//    is (resident block, first streamed block, blocks a head, step range
//    [begin, end), workspace slot): step i is head i / count, block
//    first + i % count. The wrapper splits a long chain of steps over
//    several entries, so that a pass has about a wave of CTAs or more and
//    no chain far above the mean, and sorts them heaviest first.
//  * A dK/dV step: S^T = K Q^T and dP^T = V dO^T on the tensor cores, P
//    and dS per element (masked only on block pairs that straddle a mask,
//    rounded to the input type) into shared memory as [query][key], then
//    dV += P^T dO and dK += dS^T Q, accumulated in registers over the
//    entry's steps. The step also stores its dS as a dense 32 x 64 tile
//    in a workspace (kv_chains numbers the tiles).
//  * The dQ pass reads those tiles (dq_ds_kernel: blocks of 64 keys, a
//    step loads K and two dS tiles and adds dS K): five products issued
//    for the five counted. Where the tiles would pass the wrapper's cap
//    (BWD_DS_CAP, 256 MiB; 28 MB in float32 at gemma3-1b's local layer),
//    the dQ pass computes S and dP again (dq_kernel, the dK/dV pass's CTA
//    body with queries resident: blocks of 32 keys, seven products).
//  * float32: split-precision TF32 ("3xTF32") on mma.sync m16n8k8: each
//    operand x = hi + lo as its fragment loads from shared memory, hi = x
//    itself (the tensor core reads a TF32 operand's top 19 bits, so x
//    enters truncated) and lo = x - trunc(x) (an AND and a subtraction),
//    and lo hi' + hi lo' + hi hi' summed in float32, within float32's bar
//    where one TF32 product is not. The scores keep the small products in
//    accumulators of their own. Shared-memory reads are conflict-free in
//    both orientations: the resident tiles rows DP + 16 floats apart, read
//    along rows 16 bytes a lane (lane (g, t) reads columns 4 t.. of rows g
//    and g + 8; the k index t of a step is column 4 t + 2 h); the streamed
//    tiles rows DP apart with 16-byte chunks swizzled by row (word c of row
//    i at c ^ ((i & 1) << 4 | (i & 2) << 2)), read along rows the same way
//    and down columns 4 bytes a lane (k index t is row t: banks
//    (n ^ swizzle(t))); P and dS rows 72 floats apart (8 mod 32: banks
//    8 t + g down columns). No tile is transposed or held twice.
//  * bf16: mma.sync m16n8k16 with bf16 operands, fragments by ldmatrix
//    (along rows) and ldmatrix.trans (down columns), rows DP + 8 elements
//    apart (16 mod 128 bytes, conflict-free).
//  * Eight warps. S and dP (64 x 32): a warp 16 x 16 of both. The outputs
//    (64 x DP): a warp 32 rows x DP / 4 columns (16 x 16 at DP = 32), in
//    registers: at DP = 256, dK and dV take 128 floats a lane.
//  * Streamed tiles by 16-byte cp.async (zero-filled past S, T and D) in a
//    ring of three stages where shared memory allows it without costing a
//    CTA an SM, else two, else one; plain loads where a row is not a
//    multiple of 16 bytes. Shared memory at DP = 256, dK/dV pass: float32,
//    resident K, V 2 x 64 x 272 floats, one stage of 2 x 32 x 256, P and
//    dS 2 x 32 x 72, lse and delta 2 x 64: 223,744 bytes of the 232,448 a
//    CTA may have (two stages would need 289,280), so the one stage
//    reloads each part as soon as the step is done with it (dO during
//    dK); bf16, rows of 264 and 72, three stages: 178,944 bytes. The dQ
//    pass from dS: two stages of K (64 x 256) and dS (64 x 68), 165,888
//    bytes in float32; 86,016 in bf16 (two CTAs an SM).
//  * An entry that owns its resident block's whole chain writes the
//    gradient in the input type; the entries of a split chain write
//    float32 partials to a workspace slot each, and a reduce kernel sums
//    them in slot order: no atomics, so two calls on the same inputs give
//    bitwise-equal gradients.
//  * Launches a call: delta (one warp a row), the dK/dV pass, the dQ pass,
//    and the reduce where some chain was split: three or four CUDA
//    kernels (BackwardPlan.kernels says which).

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BR = 64;  // resident rows of a CTA (keys, or queries)
constexpr int BC = 32;  // streamed rows a step (queries, or keys)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 256;
constexpr int kItem = 6;    // ints of a work-list entry
constexpr int kReduce = 4;  // ints of a reduce entry
constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Shared-memory rows (elements). float32: resident tiles DP + 16 apart
// (16 mod 32 words: 16-byte loads along rows hit distinct banks), streamed
// tiles DP apart with their 16-byte chunks swizzled by row (swz: 16-byte
// loads along rows and 4-byte loads down columns both conflict-free), the
// staged P and dS BR + 8 apart (8 mod 32: read down columns). bf16: every
// tile 8 elements over (16 mod 128 bytes, for ldmatrix).
template <typename T, int DP>
struct Rows {
  static constexpr int r = DP + 16, c = DP, s = BR + 8;
};
template <int DP>
struct Rows<bf16, DP> {
  static constexpr int r = DP + 8, c = DP + 8, s = BR + 8;
};

// The float32 streamed tiles' swizzle: row i's words c live at c ^ swz(i)
// (a multiple of 8, so 16-byte chunks stay whole).
template <typename T>
__device__ __forceinline__ int swz(int i) {
  return ((i & 1) << 4) | ((i & 2) << 2);
}
template <>
__device__ __forceinline__ int swz<bf16>(int) {
  return 0;
}

// Shared memory, in elements of T and then floats: resident tiles R1, R2
// (BR rows), the streamed tiles C1, C2 of each stage (BC rows), the staged
// P and dS ([BC][BR]), then the query rows' lse (log2 units) and delta.
template <typename T, int DP>
constexpr int smem_bytes(int stages) {
  using W = Rows<T, DP>;
  return (int)sizeof(T) *
             (2 * BR * W::r + 2 * stages * BC * W::c + 2 * BC * W::s) +
         (int)sizeof(float) * 2 * (BR > stages * BC ? BR : stages * BC);
}

template <typename T, int DP>
struct Layout {
  static constexpr int ldr = Rows<T, DP>::r;
  static constexpr int ldc = Rows<T, DP>::c;
  static constexpr int lds = Rows<T, DP>::s;
  static constexpr int res = BR * ldr;
  static constexpr int str = BC * ldc;
  static constexpr int stage = BC * lds;
  // two CTAs an SM where their shared memory fits (228 KB an SM, 1 KB of
  // it reserved a CTA; registers are then capped at 128 a thread)
  static constexpr int ctas_at(int stages) {
    return 2 * (smem_bytes<T, DP>(stages) + 1024) <= 233472 ? 2 : 1;
  }
  // a ring of three stages where it fits without costing a CTA, else two,
  // else one
  static constexpr int stages =
      smem_bytes<T, DP>(2) > kMaxSmem ? 1
      : smem_bytes<T, DP>(3) <= kMaxSmem && ctas_at(3) == ctas_at(2) ? 3
                                                                      : 2;
  static constexpr int rows = BR > stages * BC ? BR : stages * BC;
  static constexpr int c_off = 2 * res;                  // C tiles
  static constexpr int s_off = c_off + 2 * stages * str;  // P, dS
  static constexpr int bytes = smem_bytes<T, DP>(stages);
  static constexpr int ctas = ctas_at(stages);
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float zero_as(float) { return 0.f; }
__device__ __forceinline__ bf16 zero_as(bf16) { return __float2bfloat16(0.f); }
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ bf16 round_to(float x, bf16) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [r0, r0 + rows) of a row-major (n_rows, D) matrix as a rows x DP
// tile (row stride ld, swizzled by swz where SWZ), zeros past n_rows and
// D: 16-byte cp.async where vec (rows of a multiple of 16 bytes, aligned),
// else plain loads.
template <typename T, int DP, bool SWZ>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int r0, int rows, int n_rows, int D,
                                          bool vec) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);  // elements a copy
    constexpr int C = DP / E;               // copies a row
    for (int e = threadIdx.x; e < rows * C; e += kThreads) {
      const int i = e / C, c = (e % C) * E;
      const bool in = r0 + i < n_rows && c < D;
      cp_async16_zfill(dst + i * ld + (SWZ ? c ^ swz<T>(i) : c),
                       in ? src + (size_t)(r0 + i) * D + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * DP; e += kThreads) {
      const int i = e / DP, c = e % DP;
      dst[i * ld + (SWZ ? c ^ swz<T>(i) : c)] =
          r0 + i < n_rows && c < D ? src[(size_t)(r0 + i) * D + c]
                                   : zero_as(T());
    }
  }
}

// -- float32: split-precision TF32 on mma.sync m16n8k8 ----------------------

// x = hi + lo for the tensor core, which reads a TF32 operand's top 19 bits
// (its low 13 ignored: x truncated): hi is x as it is, lo the exact rest
// x - trunc(x), itself truncated as it is read. Two instructions.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(small, al, bh);
  mma_tf32(small, ah, bl);
  mma_tf32(big, ah, bh);
}

// X1 = R1 C1^T and X2 = R2 C2^T over DP (16 rows of r1, r2 x 16 rows of
// c1, c2, both read along rows). Lane (g, t) loads columns 16 s + 4 t .. + 3
// of its rows with one 16-byte load; the k index t of step h is column
// 4 t + 2 h, t + 4 column 4 t + 2 h + 1, in both operands. The small
// products keep accumulators of their own, added at the end.
template <int DP>
__device__ __forceinline__ void scores(float (&x1)[1][2][4],
                                       float (&x2)[1][2][4], const float* r1,
                                       const float* r2, int ldr,
                                       const float* c1, const float* c2,
                                       int ldc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int f = swz<float>(g);  // c rows 8 j + g: swizzled as row g
  float s1[2][4], s2[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x1[0][j][e] = x2[0][j][e] = s1[j][e] = s2[j][e] = 0.f;
#pragma unroll 2
  for (int s = 0; s < DP / 16; ++s) {
    const int col = 16 * s + 4 * t;
    float4 a[2][2], b[2][2];  // [operand][row half or n-tile]
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      a[0][u] = *reinterpret_cast<const float4*>(r1 + (g + 8 * u) * ldr + col);
      a[1][u] = *reinterpret_cast<const float4*>(r2 + (g + 8 * u) * ldr + col);
      b[0][u] = *reinterpret_cast<const float4*>(c1 + (8 * u + g) * ldc +
                                                 (col ^ f));
      b[1][u] = *reinterpret_cast<const float4*>(c2 + (8 * u + g) * ldc +
                                                 (col ^ f));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        uint32_t ah[4], al[4], bh[2][2], bl[2][2];
        split(h ? a[o][0].z : a[o][0].x, ah[0], al[0]);
        split(h ? a[o][1].z : a[o][1].x, ah[1], al[1]);
        split(h ? a[o][0].w : a[o][0].y, ah[2], al[2]);
        split(h ? a[o][1].w : a[o][1].y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          split(h ? b[o][j].z : b[o][j].x, bh[j][0], bl[j][0]);
          split(h ? b[o][j].w : b[o][j].y, bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mma3(o ? x2[0][j] : x1[0][j], o ? s2[j] : s1[j], ah, al, bh[j],
               bl[j]);
      }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x1[0][j][e] += s1[j][e];
      x2[0][j][e] += s2[j][e];
    }
}

// acc (16 MT x 8 NT) += A B over k_len, both read down columns: A (the
// staged P or dS, [k][m], a at column m0) and B (a streamed tile, [k][n],
// swizzled, columns n0..). The k index t of a step is row t, t + 4 row
// t + 4: banks 8 t + g in the stage, (n ^ swz(t)) in the tile.
template <int MT, int NT, bool A_ROWS = false>
__device__ __forceinline__ void out_mma(float (&acc)[MT][NT][4],
                                        const float* a, int lda,
                                        const float* b, int ldb, int n0,
                                        int k_len) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int f = swz<float>(t);  // rows k0 + t and k0 + t + 4, k0 % 8 == 0
#pragma unroll 2
  for (int k0 = 0; k0 < k_len; k0 += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (A_ROWS) {  // a[m][k] at a[m * lda + k] (lda 4 mod 32: 4 g + t)
        const float* p = a + (16 * mt + g) * lda + k0 + t;
        split(p[0], ah[mt][0], al[mt][0]);
        split(p[8 * lda], ah[mt][1], al[mt][1]);
        split(p[4], ah[mt][2], al[mt][2]);
        split(p[8 * lda + 4], ah[mt][3], al[mt][3]);
        continue;
      }
      const float* p = a + (k0 + t) * lda + 16 * mt + g;
      split(p[0], ah[mt][0], al[mt][0]);
      split(p[8], ah[mt][1], al[mt][1]);
      split(p[4 * lda], ah[mt][2], al[mt][2]);
      split(p[4 * lda + 8], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* p = b + (k0 + t) * ldb + ((n0 + 8 * nt + g) ^ f);
      split(p[0], bh[nt][0], bl[nt][0]);
      split(p[4 * ldb], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma3(acc[mt][nt], acc[mt][nt], ah[mt], al[mt], bh[nt], bl[nt]);
  }
}

// -- bf16: mma.sync m16n8k16 ------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// acc (16 MT x 8 NT, NT even) += A B over k_len: A and B fragments by
// ldmatrix along rows (a at (m0, k0): a[m][k] at a[m * lda + k]; b[k][n] at
// b[n * ldb + k]) or by ldmatrix.trans down columns (a[k * lda + m],
// b[k * ldb + n]): B by COLS, A by A_COLS.
template <int MT, int NT, bool COLS, bool A_COLS = COLS>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const bf16* a, int lda,
                                         const bf16* b, int ldb, int k_len) {
  static_assert(NT % 2 == 0, "bf16 B fragments load two n-tiles at once");
  const int lane = threadIdx.x & 31;
  const int r8 = lane & 7, hi8 = (lane >> 4) << 3;
  const int mid8 = ((lane >> 3) & 1) << 3;
#pragma unroll 2
  for (int k0 = 0; k0 < k_len; k0 += 16) {
    uint32_t af[MT][4], bf[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (A_COLS)  // matrices (k0, m0), (k0, m8), (k8, m0), (k8, m8)
        ldsm_x4_t(af[mt], a + (k0 + hi8 + r8) * lda + 16 * mt + mid8);
      else       // lanes 0-15 rows m0..m15 at k0, 16-31 at k8
        ldsm_x4(af[mt], a + (16 * mt + (lane & 15)) * lda + k0 + hi8);
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t r[4];
      if (COLS)  // matrices (k0, n0), (k8, n0), (k0, n8), (k8, n8)
        ldsm_x4_t(r, b + (k0 + mid8 + r8) * ldb + 8 * nt + hi8);
      else       // matrices (n0, k0), (n0, k8), (n8, k0), (n8, k8)
        ldsm_x4(r, b + (8 * nt + hi8 + r8) * ldb + k0 + mid8);
      bf[nt][0] = r[0];
      bf[nt][1] = r[1];
      bf[nt + 1][0] = r[2];
      bf[nt + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
  }
}

// the bf16 twins of scores and out_mma
template <int DP>
__device__ __forceinline__ void scores(float (&x1)[1][2][4],
                                       float (&x2)[1][2][4], const bf16* r1,
                                       const bf16* r2, int ldr,
                                       const bf16* c1, const bf16* c2,
                                       int ldc) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x1[0][j][e] = x2[0][j][e] = 0.f;
  warp_mma<1, 2, false>(x1, r1, ldr, c1, ldc, DP);
  warp_mma<1, 2, false>(x2, r2, ldr, c2, ldc, DP);
}

template <int MT, int NT, bool A_ROWS = false>
__device__ __forceinline__ void out_mma(float (&acc)[MT][NT][4],
                                        const bf16* a, int lda,
                                        const bf16* b, int ldb, int n0,
                                        int k_len) {
  warp_mma<MT, NT, true, !A_ROWS>(acc, a, lda, b + n0, ldb, k_len);
}

// -- the passes -------------------------------------------------------------

struct Params {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out1, *out2;  // dK, dV (dK/dV pass) or dQ
  float* ws;          // partials of split chains
  const int* items;
  const int* chains;  // a key block's (first, count, first dS tile)
  void* ds;           // the stored dS tiles, or null
  int H, KH, S, T, D, causal, window, vec;
  float scale, scale_log2;
};

template <int DP>
struct OutTiling {  // the outputs' 64 x DP over eight warps
  static constexpr int WD = DP / 16 < 4 ? DP / 16 : 4;  // warps along D
  static constexpr int WR = kWarps / WD;
  static constexpr int MT = BR / (16 * WR);
  static constexpr int NT = DP / (8 * WD);
};

// One work-list entry of a pass (dkdv_kernel, dq_kernel). KV: resident 64
// keys of (b, kv head), streamed 32-query blocks of its G heads;
// accumulates dV (acc1 from P) and dK (acc2 from dS), and stores dS tiles
// where p.ds is set. Q: resident 64 queries of (b, head), streamed 32-key
// blocks; accumulates dQ (acc2).
template <typename T, int DP, bool KV>
__device__ __forceinline__ void pass_body(const Params& p) {
  using L = Layout<T, DP>;
  using O = OutTiling<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* r1_s = sm;
  T* r2_s = sm + L::res;
  T* stage_p = sm + L::s_off;
  T* stage_ds = stage_p + L::stage;
  float* lse_s = reinterpret_cast<float*>(sm + L::s_off + 2 * L::stage);
  float* delta_s = lse_s + L::rows;

  const int* it = p.items + (size_t)blockIdx.x * kItem;
  const int resident = it[0], first = it[1], count = it[2];
  const int begin = it[3], end = it[4], slot = it[5];
  const int G = p.H / p.KH, offset = p.T - p.S;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);

  // the resident block: rows r0.. of the (n_res, D) matrices res1, res2
  int b, kh, r0, n_res;
  size_t res_row;  // first row of the resident matrices' head
  if (KV) {
    const int nkb = cdiv(p.T, BR), bkh = resident / nkb;
    b = bkh / p.KH;
    kh = bkh % p.KH;
    r0 = (resident % nkb) * BR;
    n_res = p.T;
    res_row = (size_t)bkh * p.T;
  } else {
    const int nqb = cdiv(p.S, BR), bh = resident / nqb;
    b = bh / p.H;
    kh = bh % p.H / G;
    r0 = (resident % nqb) * BR;
    n_res = p.S;
    res_row = (size_t)bh * p.S;
  }
  const T* res1 = (KV ? k : q) + res_row * p.D;
  const T* res2 = (KV ? v : dout) + res_row * p.D;
  load_tile<T, DP, false>(r1_s, L::ldr, res1, r0, BR, n_res, p.D, p.vec);
  load_tile<T, DP, false>(r2_s, L::ldr, res2, r0, BR, n_res, p.D, p.vec);
  if (!KV && threadIdx.x < BR) {  // the resident queries' lse and delta
    const int s = r0 + threadIdx.x;
    lse_s[threadIdx.x] = s < p.S ? p.lse[res_row + s] * kLog2e : 0.f;
    delta_s[threadIdx.x] = s < p.S ? p.delta[res_row + s] : 0.f;
  }

  // step i: the streamed rows c0.. of (head's) C1, C2 into stage st
  auto stream = [&](int i, int& c0, size_t& head_row) {
    if (KV) {
      const int g = i / count;
      c0 = (first + i % count) * BC;
      head_row = (size_t)(b * p.H + kh * G + g) * p.S;
    } else {
      c0 = (first + i) * BC;
      head_row = (size_t)(b * p.KH + kh) * p.T;
    }
  };
  // step i's streamed tiles into stage st: C1 (parts & 1), C2 and, in the
  // dK/dV pass, the queries' lse and delta (parts & 2)
  auto load_stream = [&](int st, int i, int parts) {
    int c0;
    size_t head_row;
    stream(i, c0, head_row);
    T* c1_s = sm + L::c_off + 2 * st * L::str;
    const int n_str = KV ? p.S : p.T;
    if (parts & 1)
      load_tile<T, DP, true>(c1_s, L::ldc, (KV ? q : k) + head_row * p.D, c0,
                             BC, n_str, p.D, p.vec);
    if (parts & 2)
      load_tile<T, DP, true>(c1_s + L::str, L::ldc,
                             (KV ? dout : v) + head_row * p.D, c0, BC, n_str,
                             p.D, p.vec);
    if (KV && (parts & 2) && threadIdx.x < BC) {
      const int s = c0 + threadIdx.x;
      lse_s[st * BC + threadIdx.x] =
          s < p.S ? p.lse[head_row + s] * kLog2e : 0.f;
      delta_s[st * BC + threadIdx.x] = s < p.S ? p.delta[head_row + s] : 0.f;
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // scores: warp (ra, ca) gives resident rows 16 ra.., streamed 16 ca..
  const int ra = warp & 3, ca = warp >> 2;
  // outputs: warp (wr, wd) gives rows 16 MT wr.., columns DP / WD wd..
  const int wr = warp / O::WD, wd = warp % O::WD;
  float acc1[O::MT][O::NT][4], acc2[O::MT][O::NT][4];
#pragma unroll
  for (int mt = 0; mt < O::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < O::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[mt][nt][e] = acc2[mt][nt][e] = 0.f;

  // the ring: steps begin .. begin + stages - 2 in flight before the loop;
  // one group committed a step (empty past the end), so that waiting for
  // all but the newest stages - 2 groups lands this step's tiles. One
  // stage: each part reloads as soon as the step is done with it.
  constexpr int NS = L::stages;
#pragma unroll
  for (int u = 0; u < (NS > 1 ? NS - 1 : 1); ++u) {
    if (begin + u < end) load_stream(u, begin + u, 3);
    cp_async_commit();
  }
  for (int i = begin; i < end; ++i) {
    const int st = NS > 1 ? (i - begin) % NS : 0;
    cp_async_wait<(NS > 1 ? NS - 2 : 0)>();  // this step's tiles landed
    __syncthreads();  // ... for every thread; step i - 1's stage is free
    if (NS > 1) {
      const int nx = i + NS - 1;
      if (nx < end) load_stream((nx - begin) % NS, nx, 3);
      cp_async_commit();
    }
    const T* c1_s = sm + L::c_off + 2 * st * L::str;
    const T* c2_s = c1_s + L::str;

    // X1 = R1 C1^T, X2 = R2 C2^T: resident rows x streamed rows
    float x1[1][2][4], x2[1][2][4];
    scores<DP>(x1, x2, r1_s + 16 * ra * L::ldr, r2_s + 16 * ra * L::ldr,
               L::ldr, c1_s + 16 * ca * L::ldc, c2_s + 16 * ca * L::ldc,
               L::ldc);

    // P and dS of the warp's 16 x 16, staged as [streamed][resident]; the
    // masks only on a block pair that straddles one of them
    int c0;
    size_t head_row;
    stream(i, c0, head_row);
    const int q0 = KV ? c0 : r0, nq = KV ? BC : BR;  // the queries
    const int k0 = KV ? r0 : c0, nk = KV ? BR : BC;  // the keys
    const bool full = q0 + nq <= p.S && k0 + nk <= p.T &&
                      (!p.causal || q0 + offset >= k0 + nk - 1) &&
                      (p.window <= 0 || q0 + nq - 1 + offset - k0 < p.window);
    // the queries' lse and delta: by column (KV) or by row
    float lq[4], dl[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int qi = KV ? 16 * ca + 8 * (u >> 1) + 2 * t + (u & 1)
                        : 16 * ra + g + 8 * (u & 1);
      lq[u] = lse_s[(KV ? st * BC : 0) + qi];
      dl[u] = delta_s[(KV ? st * BC : 0) + qi];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * ra + g + 8 * (e >> 1);
        const int c = 16 * ca + 8 * j + 2 * t + (e & 1);
        bool ok = true;
        if (!full) {
          const int s = KV ? c0 + c : r0 + r;     // the query
          const int kpos = KV ? r0 + r : c0 + c;  // the key
          const int qpos = s + offset;
          ok = s < p.S && kpos < p.T && (!p.causal || qpos >= kpos) &&
               (p.window <= 0 || qpos - kpos < p.window);
        }
        const int u = KV ? 2 * j + (e & 1) : e >> 1;
        const float pr =
            ok ? exp2f(x1[0][j][e] * p.scale_log2 - lq[u]) : 0.f;
        const float ds = pr * (x2[0][j][e] - dl[u]) * p.scale;
        if (KV) stage_p[c * L::lds + r] = round_to(pr, T());
        stage_ds[c * L::lds + r] = round_to(ds, T());
      }
    __syncthreads();
    if (KV && p.ds != nullptr) {  // dS for the dQ pass: a dense 32 x 64 tile
      constexpr int E = 16 / (int)sizeof(T), C = BR / E;
      T* tile = static_cast<T*>(p.ds) +
                (size_t)(p.chains[3 * resident + 2] + i) * BC * BR;
      for (int e = threadIdx.x; e < BC * C; e += kThreads) {
        const int row = e / C, col = (e % C) * E;
        *reinterpret_cast<uint4*>(tile + row * BR + col) =
            *reinterpret_cast<const uint4*>(stage_ds + row * L::lds + col);
      }
    }

    // outputs += stage^T C: down the columns of both (dV from C2 = dO
    // first, so that with one stage the next dO loads during dK; the dQ
    // pass is done with C2 = V here)
    const int m0 = 16 * O::MT * wr, n0 = DP / O::WD * wd;
    const bool more = NS == 1 && i + 1 < end;
    if (KV) {
      out_mma(acc1, stage_p + m0, L::lds, c2_s, L::ldc, n0, BC);
      if (more) __syncthreads();
    }
    if (more) {
      load_stream(0, i + 1, 2);
      cp_async_commit();
    }
    out_mma(acc2, stage_ds + m0, L::lds, c1_s, L::ldc, n0, BC);
    if (more) {
      __syncthreads();
      load_stream(0, i + 1, 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // epilogue: the gradient in T where the entry owns its chain, else the
  // float32 partial into the entry's slot
  const int n0 = DP / O::WD * wd;
#pragma unroll
  for (int mt = 0; mt < O::MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * O::MT * wr + 16 * mt + g + 8 * half;
      if (r0 + r >= n_res) continue;
      const size_t row = res_row + r0 + r;
#pragma unroll
      for (int nt = 0; nt < O::NT; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = n0 + 8 * nt + 2 * t + u;
          if (col >= p.D) continue;
          const int e = 2 * half + u;
          if (slot < 0) {
            if (KV) {
              store_as(static_cast<T*>(p.out1) + row * p.D + col,
                       acc2[mt][nt][e]);
              store_as(static_cast<T*>(p.out2) + row * p.D + col,
                       acc1[mt][nt][e]);
            } else {
              store_as(static_cast<T*>(p.out1) + row * p.D + col,
                       acc2[mt][nt][e]);
            }
          } else {
            float* w =
                p.ws + ((size_t)slot * (KV ? 2 : 1) * BR + r) * p.D + col;
            w[0] = acc2[mt][nt][e];
            if (KV) w[(size_t)BR * p.D] = acc1[mt][nt][e];
          }
        }
    }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, (Layout<T, DP>::ctas))
    dkdv_kernel(Params p) {
  pass_body<T, DP, true>(p);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, (Layout<T, DP>::ctas))
    dq_kernel(Params p) {
  pass_body<T, DP, false>(p);
}

// The dQ pass where the dK/dV pass stored dS: one work-list entry, 64
// queries of (b, head) resident, streamed blocks of 64 keys: each step
// loads the key block's K and the two 32 x 64 dS tiles of the resident
// queries (zeros where the key block's chain holds no such tile: no
// query there sees the block) and adds dS K. Tiles: K swizzled as the
// streamed tiles of the passes, dS rows BR + 4 (float32) or + 8 (bf16).
template <typename T, int DP>
struct DsLayout {
  static constexpr int ldk = Rows<T, DP>::c;
  static constexpr int ldd = BR + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int stage = BR * ldk + BR * ldd;  // elements
  static constexpr int bytes_at(int n) { return (int)sizeof(T) * stage * n; }
  static constexpr int ctas_at(int n) {
    return 2 * (bytes_at(n) + 1024) <= 233472 ? 2 : 1;
  }
  static constexpr int stages =
      bytes_at(3) <= kMaxSmem && ctas_at(3) == ctas_at(2) ? 3 : 2;
  static constexpr int bytes = bytes_at(stages);
  static constexpr int ctas = ctas_at(stages);
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, (DsLayout<T, DP>::ctas))
    dq_ds_kernel(Params p) {
  using L = DsLayout<T, DP>;
  using O = OutTiling<DP>;
  constexpr int NS = L::stages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int* it = p.items + (size_t)blockIdx.x * kItem;
  const int resident = it[0], first = it[1];
  const int begin = it[3], end = it[4], slot = it[5];
  const int G = p.H / p.KH, nqb = cdiv(p.S, BR), nkb = cdiv(p.T, BR);
  const int bh = resident / nqb, b = bh / p.H, h = bh % p.H, kh = h / G;
  const int r0 = (resident % nqb) * BR;
  const size_t kv_row = (size_t)(b * p.KH + kh) * p.T;
  const T* k = static_cast<const T*>(p.k) + kv_row * p.D;
  const T* ds = static_cast<const T*>(p.ds);

  auto load_step = [&](int st, int i) {
    const int kb = first + i;
    T* k_s = sm + st * L::stage;
    T* d_s = k_s + BR * L::ldk;
    load_tile<T, DP, true>(k_s, L::ldk, k, kb * BR, BR, p.T, p.D, p.vec);
    const int* ch = p.chains + 3 * ((b * p.KH + kh) * nkb + kb);
    const int cf = ch[0], cc = ch[1], base = ch[2];
    constexpr int E = 16 / (int)sizeof(T), C = BR / E;
    for (int e = threadIdx.x; e < BR * C; e += kThreads) {
      const int row = e / C, col = (e % C) * E, half = row / BC;
      const int j = (r0 / BC + half) - cf;  // the 32-query block's step
      const bool in = j >= 0 && j < cc;
      const T* src = in ? ds + ((size_t)(base + (h % G) * cc + j) * BC +
                                row % BC) * BR + col
                        : ds;
      cp_async16_zfill(d_s + row * L::ldd + col, src, in);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / O::WD, wd = warp % O::WD;
  const int m0 = 16 * O::MT * wr, n0 = DP / O::WD * wd;
  float acc[O::MT][O::NT][4];
#pragma unroll
  for (int mt = 0; mt < O::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < O::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int u = 0; u < NS - 1; ++u) {
    if (begin + u < end) load_step(u, begin + u);
    cp_async_commit();
  }
  for (int i = begin; i < end; ++i) {
    const int st = (i - begin) % NS;
    cp_async_wait<NS - 2>();
    __syncthreads();
    const int nx = i + NS - 1;
    if (nx < end) load_step((nx - begin) % NS, nx);
    cp_async_commit();
    const T* k_s = sm + st * L::stage;
    out_mma<O::MT, O::NT, true>(acc, k_s + BR * L::ldk + m0 * L::ldd, L::ldd,
                                k_s, L::ldk, n0, BR);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < O::MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + 16 * mt + g + 8 * half;
      if (r0 + r >= p.S) continue;
      const size_t row = (size_t)bh * p.S + r0 + r;
#pragma unroll
      for (int nt = 0; nt < O::NT; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = n0 + 8 * nt + 2 * t + u;
          if (col >= p.D) continue;
          const float x = acc[mt][nt][2 * half + u];
          if (slot < 0)
            store_as(static_cast<T*>(p.out1) + row * p.D + col, x);
          else
            p.ws[((size_t)slot * BR + r) * p.D + col] = x;
        }
    }
}

// Sum the partials of each split chain in slot order: entry (pass,
// resident, first slot, pieces); 64 threads a row of the resident block,
// four columns each (one 16-byte load a partial where D % 4 == 0).
template <typename T>
__global__ void __launch_bounds__(256) sum_partials_kernel(
    const int* __restrict__ entries, const float* __restrict__ kv_ws,
    const float* __restrict__ q_ws, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, int H, int KH, int S, int T_len, int D) {
  const int* e = entries + (size_t)blockIdx.x * kReduce;
  const int kv = e[0] == 0, resident = e[1], slot0 = e[2], n = e[3];
  const int r = blockIdx.y * 4 + threadIdx.x / 64, c = 4 * (threadIdx.x % 64);
  const int n_res = kv ? T_len : S, nb = cdiv(n_res, BR);
  const int row_in = (resident % nb) * BR + r;
  if (row_in >= n_res || c >= D) return;
  const size_t row = (size_t)(resident / nb) * n_res + row_in;
  const int planes = kv ? 2 : 1;  // dK, dV partials, or dQ's
  const float* ws = kv ? kv_ws : q_ws;
  T* out[2] = {kv ? dk : dq, dv};
  for (int pl = 0; pl < planes; ++pl) {
    const float* w = ws + ((size_t)slot0 * planes * BR + pl * BR + r) * D + c;
    const size_t step = (size_t)planes * BR * D;  // one slot
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    if (D % 4 == 0) {
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(w + j * step);
        sum[0] += x.x;
        sum[1] += x.y;
        sum[2] += x.z;
        sum[3] += x.w;
      }
    } else {
      for (int j = 0; j < n; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < D) sum[u] += w[j * step + u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c + u < D) store_as(out[pl] + row * D + c + u, sum[u]);
  }
}

// delta = rowsum(dO * O) in float32: one warp a row (B * H * S rows).
template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // a whole warp leaves together
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(to_float(o[(size_t)row * D + c]),
               to_float(dout[(size_t)row * D + c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

struct Call {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  const int *kv_items, *q_items, *reduce, *kv_chains;
  float *kv_ws, *q_ws;
  void* ds_ws;
  int B, H, KH, S, T, D, causal, window, n_kv, n_q, n_reduce, vec;
};

template <typename K>
cudaError_t raise_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int DP>
int launch(const Call& c, cudaStream_t stream) {
  // the shared-memory limits are raised once per device
  static int raised[64] = {};
  const int smem = Layout<T, DP>::bytes, smem_ds = DsLayout<T, DP>::bytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    if ((err = raise_smem(dkdv_kernel<T, DP>, smem)) != cudaSuccess ||
        (err = raise_smem(dq_kernel<T, DP>, smem)) != cudaSuccess ||
        (err = raise_smem(dq_ds_kernel<T, DP>, smem_ds)) != cudaSuccess)
      return (int)err;
    raised[dev] = 1;
  }
  const int rows = c.B * c.H * c.S;
  delta_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(c.o), static_cast<const T*>(c.dout), c.delta,
      rows, c.D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  Params p;
  p.q = c.q;
  p.k = c.k;
  p.v = c.v;
  p.dout = c.dout;
  p.lse = c.lse;
  p.delta = c.delta;
  p.chains = c.kv_chains;
  p.ds = c.ds_ws;
  p.H = c.H;
  p.KH = c.KH;
  p.S = c.S;
  p.T = c.T;
  p.D = c.D;
  p.causal = c.causal;
  p.window = c.window;
  p.vec = c.vec;
  p.scale = rsqrtf((float)c.D);
  p.scale_log2 = p.scale * kLog2e;
  p.out1 = c.dk;
  p.out2 = c.dv;
  p.ws = c.kv_ws;
  p.items = c.kv_items;
  dkdv_kernel<T, DP><<<c.n_kv, kThreads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  p.out1 = c.dq;
  p.out2 = nullptr;
  p.ws = c.q_ws;
  p.items = c.q_items;
  if (c.ds_ws != nullptr)
    dq_ds_kernel<T, DP><<<c.n_q, kThreads, smem_ds, stream>>>(p);
  else
    dq_kernel<T, DP><<<c.n_q, kThreads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (c.n_reduce > 0) {
    sum_partials_kernel<T><<<dim3(c.n_reduce, BR / 4), 256, 0, stream>>>(
        c.reduce, c.kv_ws, c.q_ws, static_cast<T*>(c.dq),
        static_cast<T*>(c.dk), static_cast<T*>(c.dv), c.H, c.KH, c.S, c.T,
        c.D);
    err = cudaGetLastError();
  }
  return (int)err;
}

template <typename T>
int launch_d(const Call& c, cudaStream_t s) {
  if (c.D <= 32) return launch<T, 32>(c, s);
  if (c.D <= 64) return launch<T, 64>(c, s);
  if (c.D <= 128) return launch<T, 128>(c, s);
  return launch<T, 256>(c, s);
}

}  // namespace
}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/flash_attention.py.
// q, o, dout, dq (B, H, S, D) and k, v, dk, dv (B, KH, T, D) of one type
// (dtype: 0 float32, 1 bf16), contiguous; lse (B, H, S) float32 from the
// forward; delta (B, H, S) float32 scratch. From backward_plan, int32 on
// the device: kv_items (n_kv x 6) and q_items (n_q x 6), the passes' work
// lists; reduce (n_reduce x 4), the split chains; kv_chains (3 ints a
// 64-key block: first, count, first dS tile). kv_ws (slots, 2, 64, D) and
// q_ws (slots, 64, D) float32 partials, null where no chain splits. ds_ws
// (tiles, 32, 64) in the input type: the dK/dV pass stores dS there and
// the dQ pass reads it, in blocks of dq_block = 64 keys; null: the dQ pass
// computes S and dP again, in blocks of dq_block = 32 keys. block_r and
// block_c must be this file's BR and BC. Three or four kernels on
// `stream`. Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, const void* kv_items, const void* q_items, const void* reduce,
    const void* kv_chains, void* kv_ws, void* q_ws, void* ds_ws, int dtype,
    int B, int H, int KH, int S, int T, int D, int causal, int window,
    int n_kv, int n_q, int n_reduce, int block_r, int block_c, int dq_block,
    void* stream) {
  using namespace repro_torch;
  if (D <= 0 || D > kMaxD || KH <= 0 || H % KH != 0 || T < S || S <= 0 ||
      B <= 0 || window < 0 || block_r != BR || block_c != BC || n_kv <= 0 ||
      n_q <= 0 || n_reduce < 0 || (n_reduce > 0 && reduce == nullptr) ||
      dq_block != (ds_ws != nullptr ? BR : BC) ||
      (ds_ws != nullptr && kv_chains == nullptr))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == kBFloat16 ? 2 : 4;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(dout);
  Call c{q, k, v, o, dout, static_cast<const float*>(lse),
         static_cast<float*>(delta), dq, dk, dv,
         static_cast<const int*>(kv_items), static_cast<const int*>(q_items),
         static_cast<const int*>(reduce), static_cast<const int*>(kv_chains),
         static_cast<float*>(kv_ws), static_cast<float*>(q_ws), ds_ws, B, H,
         KH, S, T, D, causal, window, n_kv, n_q, n_reduce,
         (D * es) % 16 == 0 && any % 16 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_d<float>(c, s);
  if (dtype == kBFloat16) return launch_d<__nv_bfloat16>(c, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
