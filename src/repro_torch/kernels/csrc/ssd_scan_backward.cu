// The backward of the Mamba-2 chunked SSD scan (csrc/ssd_scan.cu's
// forward, dt folded in): from the cotangents dy of y and dfinal of the
// final state it gives dx, ddt, dA, dB, dC and the initial state's
// gradient, in the inputs' type (float32 or bf16), accumulating in float32.
//
// Replaces no Pallas kernel: the TPU package differentiates the scan with
// jax.vjp of repro/kernels/ref.py::ssd_reference (repro has no Pallas
// backward of ssd_pallas). The port's forward is a CUDA kernel whose
// output has no autograd graph, so the card needs this kernel for a
// gradient to reach x, dt, A, B and C.
//
// The maths, per (batch row, head, chunk c), with cs the chunk's cumulative
// sum of dt A (the forward's, read from its scratch: in bf16 it is rounded
// where the forward rounds it), xd = x dt, prev_c the state entering chunk
// c (the forward's scratch too), E_c = exp(cs_last), w_j = exp(cs_last -
// cs_j) and L_ij = exp(cs_i - cs_j) for i >= j (kernels/ref.py
// ::ssd_backward_reference writes out the same passes):
//   1. dprev_c = sum_i exp(cs_i) dy_i (x) C_i;  dC_i = exp(cs_i) prev_c^T
//      dy_i;  dcs_i = C_i . dC_i
//   2. dS_last = dfinal, dS_{c-1} = dS_c E_c + dprev_c (dinitial = dS_{-1});
//      dcs_last += E_c <dS_c, prev_c>
//   3. dxd_j = w_j dS_c B_j;  dB_j = w_j dS_c^T xd_j;  with wdw_j = w_j xd_j
//      . (dS_c B_j): dcs_j -= wdw_j, dcs_last += sum_j wdw_j
//   4. P = (C B^T) o L, M = (dy xd^T) o L:  dxd += P^T dy;  dB += M^T C;
//      dC += M B;  dcs_i += sum_j (P o dy xd^T)_ij, dcs_j -= sum_i (...)_ij
//   5. d(dt A) = the reverse cumulative sum of dcs in the chunk; dx = dxd
//      dt;  ddt = sum_p dxd x + A d(dt A);  dA = sum dt d(dt A)
// B and C are one group that every head shares, so dB and dC sum over the
// heads, and dA over the rows and positions. Every rounding of the bf16
// forward other than cs's is taken as the identity (as autograd takes a
// cast); exp is only ever taken of cs_i - cs_j with i >= j, of cs_last -
// cs_j and of cs_i (cs falls), so nothing overflows.
//
// What bounds it on the H100: at mamba2-370m's training shape (4 rows of
// 1,024 tokens, 32 heads of 64, state 128, chunk 128) the products above
// come to ~11 GFLOP (the triangles' pairs on and below the diagonal; C B^T,
// M B and M^T C once a row and chunk: B and C do not depend on the head, so
// sum_h M_h^T C = (sum_h M_h)^T C), 0.16 ms at 67 TFLOP/s of float32 FMA,
// against ~0.15 GB that the function moves (inputs, the forward's states,
// gradients), 0.04 ms at 3.35 TB/s. On the tensor cores the same products
// take 0.07 ms in float32 (three TF32 products each, below) and 0.01 ms in
// bf16 (one), where the bytes bound the work (0.02 ms).
//
// What the design does: four launches, one CTA per (row, chunk, group of
// g heads) in the two chunk kernels, the heads looped inside the CTA, and
// the CTAs of one (row, chunk) a thread-block cluster (at most 8) that
// sums dB and dC through distributed shared memory:
//  (a) ssd_bwd_chunk: what needs no dS. C B^T on the 32 x 32 blocks on and
//      below the diagonal once, kept in shared memory (G); then for each
//      head (pass 4) P^T dy with P = G o L formed as the fragments load,
//      into a float32 dxd scratch (b, l, H, P), and dy xd^T on the warp's
//      triangle blocks: P o dy xd^T's row and column sums into the head's
//      dcs, and M_h = dy xd^T o L summed over the CTA's heads in registers.
//      Then M B and M^T C once on the summed M, both kept in registers;
//      then for each head (pass 1) dprev into a float32 scratch (b, chunks,
//      H, P, N) and exp(cs) dy prev added to M B (dC), its row dot with C
//      into dcs. Last dC and M^T C are summed over the cluster's CTAs in
//      rank order: dC is written (or, with more than one cluster a (row,
//      chunk), its float32 cluster partial), M^T C goes to a float32 (b, l,
//      clusters, N) scratch for (c).
//  (b) state_backward, one thread per (row, head, p, n): walks the chunks
//      from the last (the loads of 8 chunks in flight together),
//      overwrites each chunk's dprev with dS_c, writes dinitial; each CTA
//      (256 elements of one (row, head)) sums its share of <dS_c, prev_c>
//      in a fixed order into a partial per chunk.
//  (c) ssd_bwd_local: pass 3 and 5. For each head dS B^T, added to (a)'s
//      dxd, gives dx and ddt's sum over p; w dt x^T dS added over the
//      CTA's heads in registers (dB's local share). Then one warp a head:
//      dcs, its reverse cumulative sum, ddt and dA's share a (row, chunk).
//      dB = the cluster's sum plus (a)'s share, written (or its cluster
//      partial).
//  (d) ssd_bwd_sum: dA over rows and chunks and, with more than one
//      cluster a (row, chunk), dB and dC over the clusters, each in one
//      fixed order (no atomics anywhere, so two calls are bitwise equal).
// (b), (c) and (d) launch as programmatic dependents: each may start while
// the kernel before it finishes, and waits for it before reading its
// results. The partition (g, the cluster size, the CTAs' order) comes from
// kernels/ssd_scan.py::backward_plan, which fits the CTAs into as few waves
// as the card runs at once (clusters of 4 or 8 reach 120 of the H100's 132
// SMs, clusters of 2 all of them): CTA x of a (row, chunk) is rank
// x % cluster of cluster x / cluster and holds heads [x g, x g + g); a
// cluster's sum runs over its ranks in order, (d)'s over the clusters.
// The next head's tiles load with cp.async into the other of two stages
// while the current head's products run. Every product is a warp's 32 x 32
// tile on the tensor cores (mma.sync m16n8k8, TF32 with float32
// accumulation; float32 splits each operand into two TF32 halves, three
// products, within float32's 1e-4 bar; bf16 inputs are exact in TF32 and
// take one), its fragments loaded two or four elements at a time (the
// layout at Acc). Input tiles stay in their own type in shared memory
// (rows padded by 16 bytes) and widen as the fragments load; G and M are
// float32. Shared memory at chunk 128, state 128, head dim 64 and g = 8:
// (a) 229,376 bytes in float32 (G and two stages of dy and x; later C and
// two of dy and prev), (c) 227,392 (B and two stages of dS and x); one CTA
// an SM. The wrapper checks the largest against the card's limit. Ragged
// chunks (ck not a multiple of 32), ragged P and N are zero-padded to 32;
// ck <= 128, N <= 128.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;    // heads a CTA
constexpr int kMaxCluster = 8;  // CTAs a cluster (portable)

// state_backward's CTAs for one (row, head): each writes one <dS_c, prev_c>
// partial a chunk to the dot scratch (ssd_scan_backward_dot_partials).
inline int dot_partials(int P, int N) {
  return (P * N + kThreads - 1) / kThreads;
}

constexpr int kMaxCk = 128;
constexpr int kMaxN = 128;
// a warp's output tile: MT x NT tiles of 16 x 8 (the m16n8 layout), 32 x 32
constexpr int MT = 2, NT = 4, kTile = 32;
// blocks of 32 x 32 on or below C B^T's diagonal at ck = 128, a warp's
// share
constexpr int kMaxTriBlocks =
    ((kMaxCk / kTile) * (kMaxCk / kTile + 1) / 2 + kWarps - 1) / kWarps;
// output tiles of 32 x 32 of a (ck x N) product, a warp's share
constexpr int kMaxRowTiles =
    ((kMaxCk / kTile) * (kMaxN / kTile) + kWarps - 1) / kWarps;


__host__ __device__ inline int pad32(int x) { return (x + 31) / 32 * 32; }
__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Padded sizes; row strides in elements of a tile of element size es
// (16 bytes past the padded width)
struct Dims {
  int ckp, np, pp, S;
};
__host__ __device__ inline Dims make_dims(int ck, int N, int P) {
  Dims d;
  d.ckp = pad32(ck);
  d.np = pad32(N);
  d.pp = pad32(P);
  d.S = d.ckp / kTile;
  return d;
}
__host__ __device__ inline int row_ld(int cols_pad, int es) {
  return cols_pad + 16 / es;
}
// bytes of a rows_pad x cols_pad tile of element size es
__host__ __device__ inline size_t tile_bytes(int rows_pad, int cols_pad,
                                             int es) {
  return align16((size_t)rows_pad * row_ld(cols_pad, es) * es);
}
__host__ __device__ inline size_t max2(size_t a, size_t b) {
  return a > b ? a : b;
}

// (a)'s shared memory (bytes). A pool reused phase by phase: at the start B
// at 0 and C at `c`, with the first diagonal stage at `sd`; G at 0 and two
// stages of dy, x at `sd`; then M at 0, B at `bl`, C at `c`; then C at `c`
// with two stages of dy, prev at 0 and `so`; last the stagings of dC at 0
// and of M^T C at `staging`.
// Then the small float arrays: per head cs, exp(cs), dt and dcs; the row
// and column sums of P o dy xd^T by block; dcs's partials by column block.
struct ChunkLayout {
  size_t sizeG, sizeCB, stage_d, stage_o, staging;
  size_t sd, so, bl, c, pool;
  size_t cs, ecs, dt, dcs, row_q, col_q, part, total;
};
__host__ __device__ inline ChunkLayout chunk_layout(const Dims& d, int es,
                                                    int g) {
  ChunkLayout L;
  L.sizeG = tile_bytes(d.ckp, d.ckp, 4);
  L.sizeCB = tile_bytes(d.ckp, d.np, es);
  L.stage_d = 2 * tile_bytes(d.ckp, d.pp, es);
  L.stage_o = tile_bytes(d.ckp, d.pp, es) + tile_bytes(d.pp, d.np, es);
  L.staging = tile_bytes(d.ckp, d.np, 4);
  // the first diagonal stage loads beside B, so it starts past both B and G
  L.sd = max2(L.sizeG, L.sizeCB);
  size_t pool = L.sd + 2 * L.stage_d;
  pool = max2(pool, L.sd + L.stage_d + L.sizeCB);
  pool = max2(pool, 2 * L.stage_o + L.sizeCB);
  pool = max2(pool, L.sizeG + 2 * L.sizeCB);
  pool = max2(pool, 2 * L.staging);
  L.pool = pool;
  L.so = L.stage_o;
  L.bl = L.sizeG;
  L.c = pool - L.sizeCB;
  size_t o = pool;
  const size_t per_head = align16((size_t)g * d.ckp * 4);
  L.cs = o;
  o += per_head;
  L.ecs = o;
  o += per_head;
  L.dt = o;
  o += per_head;
  L.dcs = o;
  o += per_head;
  L.row_q = o;  // S x ckp: row sums of P o dy xd^T a column block
  o += align16((size_t)d.S * d.ckp * 4);
  L.col_q = o;  // S x ckp: column sums a row block
  o += align16((size_t)d.S * d.ckp * 4);
  L.part = o;  // (np / 32) x ckp: C . dC's partial a column block
  o += align16((size_t)(d.np / kTile) * d.ckp * 4);
  L.total = o;
  return L;
}

// (c)'s shared memory: B at 0, two stages of dS (float32) and x at `st`;
// dB's staging at 0 at the end. Then per head dt, w, (a)'s dcs, wdw and
// dxd . x; the row sums of x . (dS B) and dxd . x by column block; per
// head E <dS, prev> and A.
struct LocalLayout {
  size_t sizeB, stage, st, pool;
  size_t dt, w, dcs, wdw, ddt, wd_part, dd_part, head, total;
};
__host__ __device__ inline LocalLayout local_layout(const Dims& d, int es,
                                                    int g) {
  LocalLayout L;
  L.sizeB = tile_bytes(d.ckp, d.np, es);
  L.stage = tile_bytes(d.pp, d.np, 4) + tile_bytes(d.ckp, d.pp, es);
  L.st = L.sizeB;
  L.pool = max2(L.sizeB + 2 * L.stage, tile_bytes(d.ckp, d.np, 4));
  size_t o = L.pool;
  const size_t per_head = align16((size_t)g * d.ckp * 4);
  L.dt = o;
  o += per_head;
  L.w = o;
  o += per_head;
  L.dcs = o;  // (a)'s dcs, loaded at the start
  o += per_head;
  L.wdw = o;
  o += per_head;
  L.ddt = o;
  o += per_head;
  L.wd_part = o;
  o += align16((size_t)(d.pp / kTile) * d.ckp * 4);
  L.dd_part = o;
  o += align16((size_t)(d.pp / kTile) * d.ckp * 4);
  L.head = o;  // per head E <dS, prev> (cs_last's share) and A
  o += align16((size_t)2 * g * 4);
  L.total = o;
  return L;
}

template <typename E>
__device__ __forceinline__ E zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows x cols of src (row stride src_ld, element type E) into the tile dst
// of the same type (row stride row_ld(cols_pad)), zeros up to rows_pad x
// cols_pad (a multiple of 32). 16 bytes a cp.async where the rows allow
// it (the caller commits, waits and syncs), else element by element.
template <typename E>
__device__ void load_tile(E* dst, const E* __restrict__ src, size_t src_ld,
                          int rows, int cols, int rows_pad, int cols_pad) {
  constexpr int V = 16 / sizeof(E);
  const int ld = row_ld(cols_pad, sizeof(E));
  if (cols % V == 0 && src_ld % V == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int cq = cols_pad / V;
    for (int e = threadIdx.x; e < rows_pad * cq; e += kThreads) {
      const int r = e / cq, c = V * (e % cq);
      E* to = dst + (size_t)r * ld + c;
      if (r < rows && c < cols)
        cp_async16(to, src + r * src_ld + c);
      else
        *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  for (int e = threadIdx.x; e < rows_pad * cols_pad; e += kThreads) {
    const int r = e / cols_pad, c = e % cols_pad;
    dst[(size_t)r * ld + c] =
        (r < rows && c < cols) ? src[r * src_ld + c] : zero_of<E>();
  }
}

// v0, v1 to p[0], p[1], columns col and col + 1 (col even) of a row of
// width W whose start is at an even index when W is: one 8-byte store
// (4-byte in bf16) where both columns exist and W is even.
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
template <typename E>
__device__ __forceinline__ void store_pair(E* p, int col, int W, float v0,
                                           float v1) {
  if (col + 1 < W && W % 2 == 0) {
    store2(p, v0, v1);
  } else {
    if (col < W) store_as(p, v0);
    if (col + 1 < W) store_as(p + 1, v1);
  }
}
// (p[0], p[1]) widened, zeros past W, as store_pair
template <typename E>
__device__ __forceinline__ float2 load_pair(const E* p, int col, int W) {
  if (col + 1 < W && W % 2 == 0) {
    if constexpr (sizeof(E) == 4) {
      return *reinterpret_cast<const float2*>(p);
    } else {
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    }
  }
  return make_float2(col < W ? to_float(p[0]) : 0.f,
                     col + 1 < W ? to_float(p[1]) : 0.f);
}

// A warp's 32 x 32 output tile, as MT x NT tiles of 16 x 8 in the m16n8
// accumulator layout, with its rows and columns dealt so that the operands
// load in pairs and fours. Lane (g, t) = (lane / 4, lane % 4) takes, of
// each k-step of 8, the k pair 2t, 2t + 1 (the mma's k slots t and t + 4:
// the product sums over k, so their order is free) and, of each 16 rows,
// rows 2g and 2g + 1 (the mma's rows g and g + 8): an operand adjacent in k
// (K-major) or in m loads a pair at once. B's n-tile nt gives the lane
// column 8 nt + g where B is K-major (its k pair adjacent) and, where it is
// not, column 4 g + nt: the lane's four columns adjacent, one load of four
// (the "wide" layout, W). c[mt][nt][e] is then row 16 mt + 2 g + e / 2 and
// column 8 nt + 2 t + e % 2, or 8 t + 4 (e % 2) + nt where W.
using Acc = float[MT][NT][4];

__device__ __forceinline__ int acc_row(int mt, int e) {
  return 16 * mt + 2 * ((threadIdx.x % 32) / 4) + e / 2;
}
template <bool W>
__device__ __forceinline__ int acc_col(int nt, int e) {
  const int t = threadIdx.x % 4;
  return W ? 8 * t + 4 * (e % 2) + nt : 8 * nt + 2 * t + e % 2;
}

// f(row, col, c0, c1) for each pair of accumulators at columns col and
// col + 1 (col even) of one row of the warp tile
template <bool W, typename F>
__device__ __forceinline__ void for_pairs(Acc& c, F&& f) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (W) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
          for (int nt = 0; nt < NT; nt += 2)
            f(acc_row(mt, 2 * hf), acc_col<true>(nt, e2),
              c[mt][nt][2 * hf + e2], c[mt][nt + 1][2 * hf + e2]);
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          f(acc_row(mt, 2 * hf), acc_col<false>(nt, 0), c[mt][nt][2 * hf],
            c[mt][nt][2 * hf + 1]);
      }
    }
}

// f(row, col, c) for each accumulator of the warp tile
template <bool W, typename F>
__device__ __forceinline__ void for_each(Acc& c, F&& f) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(acc_row(mt, e), acc_col<W>(nt, e), c[mt][nt][e]);
}

__device__ __forceinline__ void zero(Acc& c) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;
}

// Two and four adjacent elements of shared memory, widened
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// c += A (32 x K) B (K x 32) on the tensor cores. A(m, k) is A[m lda + k]
// when A_K, else A[k lda + m]; B(k, n) is B[n ldb + k] when B_K, else
// B[k ldb + n] (the wide layout: c's layout is W = !B_K). sa(m, k, v) and
// sb(k, n, v) scale an element v as it loads (m, n < 32 within the tile,
// k < K). K is a multiple of 8; operands are zero past their data; the
// pointers and strides keep the pairs (and B's fours where not B_K)
// aligned. mma.sync m16n8k8 in TF32 with float32 accumulation, each
// operand's fragment loaded once a k-step and fed to MT or NT products.
// SPLIT = 3: each operand x = hi + lo (hi = x truncated to TF32, lo = x -
// hi, exact in float32) and lo hi' + hi lo' + hi hi' summed, within
// float32's bar; SPLIT = 1: one TF32 product (bf16 inputs are exact in
// TF32; the float32 intermediates lose their last 13 bits, far inside
// bf16's bar).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int SPLIT>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if (SPLIT == 1) {
    hi = __float_as_uint(x);  // the tensor core reads the top 19 bits
  } else {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

struct NoScale {
  __device__ __forceinline__ float operator()(int, int, float v) const {
    return v;
  }
};

template <int SPLIT, bool A_K, bool B_K, typename EA, typename EB,
          typename SA = NoScale, typename SB = NoScale>
__device__ __forceinline__ void warp_mma(Acc& c, const EA* A, int lda,
                                         const EB* B, int ldb, int K,
                                         SA sa = {}, SB sb = {}) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const int k = k0 + 2 * t;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = 16 * mt + 2 * g;
      float a[4];  // (m, k), (m + 1, k), (m, k + 1), (m + 1, k + 1)
      if (A_K) {
        const float2 r0 = ld2(A + m * lda + k), r1 = ld2(A + (m + 1) * lda + k);
        a[0] = r0.x, a[2] = r0.y, a[1] = r1.x, a[3] = r1.y;
      } else {
        const float2 q0 = ld2(A + k * lda + m), q1 = ld2(A + (k + 1) * lda + m);
        a[0] = q0.x, a[1] = q0.y, a[2] = q1.x, a[3] = q1.y;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_tf32<SPLIT>(sa(m + (q & 1), k + (q >> 1), a[q]), ah[mt][q],
                          al[mt][q]);
    }
    float bv[NT][2];
    if (B_K) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 v = ld2(B + (8 * nt + g) * ldb + k);
        bv[nt][0] = v.x, bv[nt][1] = v.y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 v = ld4(B + (k + q) * ldb + 4 * g);
        bv[0][q] = v.x, bv[1][q] = v.y, bv[2][q] = v.z, bv[3][q] = v.w;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = B_K ? 8 * nt + g : 4 * g + nt;
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        split_tf32<SPLIT>(sb(k + q, n, bv[nt][q]), bh[q], bl[q]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (SPLIT == 3) {
          mma_tf32(c[mt][nt], al[mt], bh);
          mma_tf32(c[mt][nt], ah[mt], bl);
        }
        mma_tf32(c[mt][nt], ah[mt], bh);
      }
    }
  }
}

// out[r] = the sum of row r of a warp tile's 32 columns, r < 32, by the
// lanes with t == 0 (nt and the pair, then over t). The whole warp must
// call it.
__device__ __forceinline__ void store_row_sums(const Acc& v, float* out) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float s = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        s += v[mt][nt][2 * hf] + v[mt][nt][2 * hf + 1];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (lane % 4 == 0) out[16 * mt + 2 * (lane / 4) + hf] = s;
    }
}

// out[c] = the sum of column c of a warp tile's 32 rows, c < 32, by the
// lanes with g == 0 (mt and the pair, then over g). The whole warp must
// call it.
template <bool W>
__device__ __forceinline__ void store_col_sums(const Acc& v, float* out) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      float s = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) s += v[mt][nt][cc] + v[mt][nt][2 + cc];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) out[acc_col<W>(nt, cc)] = s;
    }
}

// Block b of the lower triangle of 32 x 32 blocks: row block I holds
// blocks I (I + 1) / 2 .. I (I + 1) / 2 + I, column blocks 0 .. I.
__device__ __forceinline__ void tri_block(int b, int& I, int& J) {
  I = 0;
  while ((I + 1) * (I + 2) / 2 <= b) ++I;
  J = b - I * (I + 1) / 2;
}
// The triangle block of slot u of this warp: dealt from the last warp
// backwards, so that the warps with the deepest P^T dy tiles (the first)
// hold the fewest blocks.
__device__ __forceinline__ int tri_of(int u) {
  return (kWarps - 1 - (int)threadIdx.x / 32) + u * kWarps;
}

// The cluster's sum of a rows x cols float32 tile that every CTA staged at
// `stg` (row stride ld, a multiple of 4), over the ranks in order: each
// CTA sums an equal share of the elements and hands each sum to
// out(row, col, sum). The caller syncs the cluster before (the stagings
// are complete) and after (no CTA reuses or leaves its staging while
// another reads it).
template <typename F>
__device__ void cluster_reduce(cg::cluster_group& cluster, float* stg, int ld,
                               int rows, int cols, F&& out) {
  const int n_cta = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const float* src[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    src[r] = r < n_cta ? cluster.map_shared_rank(stg, r) : stg;
  const int V = cols % 4 == 0 ? 4 : 1;
  const int per_row = cols / V, total = rows * per_row;
  const int share = (total + n_cta - 1) / n_cta;
  const int hi = min(total, (rank + 1) * share);
  for (int e = rank * share + (int)threadIdx.x; e < hi; e += kThreads) {
    const int i = e / per_row, n = V * (e % per_row);
    const size_t at = (size_t)i * ld + n;
    if (V == 4) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < n_cta; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(src[r] + at);
        s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
      }
      out(i, n, s.x);
      out(i, n + 1, s.y);
      out(i, n + 2, s.z);
      out(i, n + 3, s.w);
    } else {
      float s = 0.f;
      for (int r = 0; r < n_cta; ++r) s += src[r][at];
      out(i, n, s);
    }
  }
}

template <typename F>
__device__ void cluster_sum(cg::cluster_group& cluster, float* stg, int ld,
                            int rows, int cols, F&& out) {
  cluster.sync();
  cluster_reduce(cluster, stg, ld, rows, cols, out);
  cluster.sync();
}

// Programmatic dependent launch: the kernels after the first may start
// while the one before finishes its last CTAs' work (the chunk kernels
// allow that near their end, the state passing at its start); each does
// what reads only the call's inputs, then waits for the one before (which
// waited for its own: so every earlier kernel has finished and its stores
// are visible).
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Write a warp's accumulator tile at (r0, c0) of the float staging (row
// stride ld)
template <bool W>
__device__ __forceinline__ void stage_tile(Acc& c, float* stg, int ld,
                                           int r0, int c0) {
  for_pairs<W>(c, [&](int r, int cc, float& v0, float& v1) {
    store2(stg + (size_t)(r0 + r) * ld + c0 + cc, v0, v1);
  });
}

// (a) ssd_bwd_chunk: grid (clusters x cluster, chunks, b), a cluster of
// `cluster` CTAs along x; CTA x holds heads [x g, x g + g) of H
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_kernel(
    const T* __restrict__ x, const T* __restrict__ dt,
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    const T* __restrict__ dy, const T* __restrict__ prev,
    const float* __restrict__ cs_g, float* __restrict__ ds_g,
    float* __restrict__ dxd_g, float* __restrict__ dcs_g,
    float* __restrict__ dbd_g, float* __restrict__ dcp_g, T* __restrict__ dC,
    int l, int H, int P, int N, int ck, int g) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kSplit = sizeof(T) == 4 ? 3 : 1;
  constexpr int es = sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  const Dims d = make_dims(ck, N, P);
  const ChunkLayout L = chunk_layout(d, es, g);
  const int q = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y, ncl = gridDim.x / (int)cluster.num_blocks();
  const int k_cl = q / (int)cluster.num_blocks();
  const int h0 = q * g, nh = max(0, min(g, H - h0));
  const int tid = threadIdx.x, warp = tid / 32;
  const size_t t0 = (size_t)b * l + (size_t)c * ck;
  const int S = d.S, ntri = S * (S + 1) / 2;
  const int npb = d.pp / kTile, nnb = d.np / kTile;
  const int ldn = row_ld(d.np, es), ldp = row_ld(d.pp, es);
  const int ldg = row_ld(d.ckp, 4), ldf = row_ld(d.np, 4);
  float* cs_s = reinterpret_cast<float*>(smem + L.cs);
  float* ecs_s = reinterpret_cast<float*>(smem + L.ecs);
  float* dt_s = reinterpret_cast<float*>(smem + L.dt);
  float* dcs_s = reinterpret_cast<float*>(smem + L.dcs);
  float* row_q = reinterpret_cast<float*>(smem + L.row_q);
  float* col_q = reinterpret_cast<float*>(smem + L.col_q);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* G_s = reinterpret_cast<float*>(smem);  // G, then M
  const T* C_s = reinterpret_cast<const T*>(smem + L.c);
  auto head_x = [&](const T* base, int u) {
    return base + t0 * H * P + (size_t)(h0 + u) * P;
  };
  auto stage_d = [&](int s) { return reinterpret_cast<T*>(smem + L.sd + s * L.stage_d); };
  auto stage_o = [&](int s) { return reinterpret_cast<T*>(smem + s * L.so); };
  const size_t dy_bytes = tile_bytes(d.ckp, d.pp, es);
  auto load_diag = [&](int u) {  // dy_u, x_u
    T* s = stage_d(u & 1);
    load_tile(s, head_x(dy, u), (size_t)H * P, ck, P, d.ckp, d.pp);
    load_tile(reinterpret_cast<T*>(reinterpret_cast<uint8_t*>(s) + dy_bytes),
              head_x(x, u), (size_t)H * P, ck, P, d.ckp, d.pp);
  };
  auto load_off = [&](int u) {  // dy_u, prev_u
    T* s = stage_o(u & 1);
    load_tile(s, head_x(dy, u), (size_t)H * P, ck, P, d.ckp, d.pp);
    load_tile(reinterpret_cast<T*>(reinterpret_cast<uint8_t*>(s) + dy_bytes),
              prev + (((size_t)b * nc + c) * H + h0 + u) * P * N, N, P, N,
              d.pp, d.np);
  };

  // B at 0, C at L.c, the first head's dy and x; per head cs, exp(cs), dt
  load_tile(reinterpret_cast<T*>(smem), Bm + t0 * N, N, ck, N, d.ckp, d.np);
  load_tile(const_cast<T*>(C_s), Cm + t0 * N, N, ck, N, d.ckp, d.np);
  cp_async_commit();
  if (nh > 0) load_diag(0);
  cp_async_commit();
  for (int e = tid; e < g * d.ckp; e += kThreads) {
    const int u = e / d.ckp, i = e % d.ckp;
    const bool in = u < nh && i < ck;
    const float v =
        in ? cs_g[((size_t)b * H + h0 + u) * l + (size_t)c * ck + i] : 0.f;
    cs_s[e] = v;
    ecs_s[e] = in ? expf(v) : 0.f;
    dt_s[e] = in ? to_float(dt[(t0 + i) * H + h0 + u]) : 0.f;
    dcs_s[e] = 0.f;
  }
  // the row and column sums of blocks above the diagonal stay 0
  for (int e = tid; e < S * d.ckp; e += kThreads) row_q[e] = col_q[e] = 0.f;
  cp_async_wait<1>();
  __syncthreads();

  // G = C B^T on the blocks on and below the diagonal, in registers, then
  // in B's place (row stride ldg); a later product reads no block above
  // the diagonal
  Acc r[kMaxTriBlocks];
  {
    const T* B_s = reinterpret_cast<const T*>(smem);
#pragma unroll
    for (int u = 0; u < kMaxTriBlocks; ++u) {
      const int blk = tri_of(u);
      zero(r[u]);
      if (blk < ntri && nh > 0) {
        int I, J;
        tri_block(blk, I, J);
        warp_mma<kSplit, true, true>(r[u], C_s + (size_t)kTile * I * ldn,
                                     ldn, B_s + (size_t)kTile * J * ldn, ldn,
                                     d.np);
      }
    }
  }
  __syncthreads();  // B and C are consumed
#pragma unroll
  for (int u = 0; u < kMaxTriBlocks; ++u) {
    const int blk = tri_of(u);
    if (blk < ntri) {
      int I, J;
      tri_block(blk, I, J);
      for_each<false>(r[u], [&](int i, int j, float& v) {
        G_s[(size_t)(kTile * I + i) * ldg + kTile * J + j] = v;
        v = 0.f;  // M's sum over the heads from here
      });
    }
  }

  // pass 4, head by head: P^T dy into dxd, P o dy xd^T's sums into dcs,
  // M = dy xd^T o L summed over the heads in r
  for (int u = 0; u < nh; ++u) {
    if (u + 1 < nh) load_diag(u + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int h = h0 + u;
    const T* dy_s = stage_d(u & 1);
    const T* x_s = reinterpret_cast<const T*>(
        reinterpret_cast<const uint8_t*>(dy_s) + dy_bytes);
    const float* cs = cs_s + u * d.ckp;
    const float* dtu = dt_s + u * d.ckp;
    // L_ij = exp(cs_i - cs_j) for j <= i < ck, else 0
    auto decay = [&](int i, int j) {
      return (j > i || i >= ck) ? 0.f : __expf(cs[i] - cs[j]);
    };
    // dxd_j = sum_i P_ij dy_i (rows j, k = i from j's block on). On the
    // diagonal block L_ij as it is; below it L_ij = exp(cs_i - cs_r)
    // exp(cs_r - cs_j) with r the block's last row: both factors <= 1, one
    // on A's row and one on B's
    for (int t = warp; t < S * npb; t += kWarps) {
      const int j0 = kTile * (t / npb), p0 = kTile * (t % npb);
      const float* Gj = G_s + (size_t)j0 * ldg + j0;
      const T* dyj = dy_s + (size_t)j0 * ldp + p0;
      const float cr = cs[j0 + kTile - 1];
      Acc acc;
      zero(acc);
      warp_mma<kSplit, false, false>(
          acc, Gj, ldg, dyj, ldp, kTile,
          [&](int m, int k, float v) { return v * decay(j0 + k, j0 + m); });
      if (j0 + kTile < d.ckp)
        warp_mma<kSplit, false, false>(
            acc, Gj + (size_t)kTile * ldg, ldg, dyj + (size_t)kTile * ldp,
            ldp, d.ckp - j0 - kTile,
            [&](int m, int, float v) {
              return v * __expf(cr - cs[j0 + m]);
            },
            [&](int k, int, float v) {
              const int i = j0 + kTile + k;
              return i < ck ? v * __expf(cs[i] - cr) : 0.f;
            });
      for_pairs<true>(acc, [&](int rr, int cc, float& v0, float& v1) {
        const int j = j0 + rr, p = p0 + cc;
        if (j < ck)
          store_pair(dxd_g + ((t0 + j) * H + h) * P + p, p, P, v0, v1);
      });
    }
    // dy xd^T on the warp's triangle blocks
#pragma unroll
    for (int v = 0; v < kMaxTriBlocks; ++v) {
      const int blk = tri_of(v);
      if (blk < ntri) {
        int I, J;
        tri_block(blk, I, J);
        Acc acc;
        zero(acc);
        warp_mma<kSplit, true, true>(acc, dy_s + (size_t)kTile * I * ldp, ldp,
                                     x_s + (size_t)kTile * J * ldp, ldp, d.pp);
        // the lane's rows' and columns' cs, and its columns' dt
        float csi[MT][2], csj[NT][2], dtj[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            csi[mt][hf] = cs[kTile * I + acc_row(mt, 2 * hf)];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int j = kTile * J + acc_col<false>(nt, e2);
            csj[nt][e2] = cs[j];
            dtj[nt][e2] = dtu[j];
          }
        float(&mv)[MT][NT][4] = r[v];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = kTile * I + acc_row(mt, e);
              const int j = kTile * J + acc_col<false>(nt, e);
              const float L = (j > i || i >= ck)
                                  ? 0.f
                                  : __expf(csi[mt][e / 2] - csj[nt][e % 2]);
              const float m = acc[mt][nt][e] * dtj[nt][e % 2] * L;
              mv[mt][nt][e] += m;
              acc[mt][nt][e] = m * G_s[(size_t)i * ldg + j];  // P o dy xd^T
            }
        store_row_sums(acc, row_q + J * d.ckp + kTile * I);
        store_col_sums<false>(acc, col_q + I * d.ckp + kTile * J);
      }
    }
    __syncthreads();
    for (int i = tid; i < ck; i += kThreads) {
      float s = 0.f;
      for (int jb = 0; jb < S; ++jb) s += row_q[jb * d.ckp + i];
      for (int ib = 0; ib < S; ++ib) s -= col_q[ib * d.ckp + i];
      dcs_s[u * d.ckp + i] += s;
    }
  }

  // M into G's place, C and B again: dC = M B (kept in registers for pass
  // 1), M^T C (dB's diagonal share)
  __syncthreads();
  T* Bl_s = reinterpret_cast<T*>(smem + L.bl);
  load_tile(Bl_s, Bm + t0 * N, N, ck, N, d.ckp, d.np);
  load_tile(const_cast<T*>(C_s), Cm + t0 * N, N, ck, N, d.ckp, d.np);
  cp_async_commit();
#pragma unroll
  for (int u = 0; u < kMaxTriBlocks; ++u) {
    const int blk = tri_of(u);
    if (blk < ntri) {
      int I, J;
      tri_block(blk, I, J);
      for_each<false>(r[u], [&](int i, int j, float& v) {
        G_s[(size_t)(kTile * I + i) * ldg + kTile * J + j] = v;
      });
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const int nrt = S * nnb;  // 32 x 32 tiles of a (ck x N) product
  Acc dc[kMaxRowTiles], db[kMaxRowTiles];
#pragma unroll
  for (int u = 0; u < kMaxRowTiles; ++u) {
    const int t = warp + u * kWarps;
    zero(dc[u]);
    zero(db[u]);
    if (t < nrt) {
      const int I = t / nnb, n0 = kTile * (t % nnb);
      // dC_i = sum_j M_ij B_j (k = j up to the end of i's block)
      warp_mma<kSplit, true, false>(dc[u], G_s + (size_t)kTile * I * ldg, ldg,
                                    Bl_s + n0, ldn, kTile * (I + 1));
      // dB_j = sum_i M_ij C_i (rows j of block I, k = i from it on)
      const int j0 = kTile * I;
      warp_mma<kSplit, false, false>(db[u], G_s + (size_t)j0 * ldg + j0, ldg,
                                     C_s + (size_t)j0 * ldn + n0, ldn,
                                     d.ckp - j0);
    }
  }
  __syncthreads();  // M and B are consumed
  if (nh > 0) load_off(0);
  cp_async_commit();

  // pass 1, head by head: dprev; exp(cs) dy prev into dC's registers and
  // its row dot with C into dcs
  for (int u = 0; u < nh; ++u) {
    if (u + 1 < nh) load_off(u + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int h = h0 + u;
    const T* dy_s = stage_o(u & 1);
    const T* pv_s = reinterpret_cast<const T*>(
        reinterpret_cast<const uint8_t*>(dy_s) + dy_bytes);
    const float* ecs = ecs_s + u * d.ckp;
    const size_t state = (((size_t)b * nc + c) * H + h) * P * N;
    // dprev (P x N) = (exp(cs) dy)^T C
    for (int t = warp; t < npb * nnb; t += kWarps) {
      const int p0 = kTile * (t / nnb), n0 = kTile * (t % nnb);
      Acc acc;
      zero(acc);
      warp_mma<kSplit, false, false>(
          acc, dy_s + p0, ldp, C_s + n0, ldn, d.ckp,
          [&](int, int k, float v) { return v * ecs[k]; });
      for_pairs<true>(acc, [&](int rr, int cc, float& v0, float& v1) {
        const int p = p0 + rr, n = n0 + cc;
        if (p < P) store_pair(ds_g + state + (size_t)p * N + n, n, N, v0, v1);
      });
    }
    // exp(cs) dy prev (ck x N)
#pragma unroll
    for (int v = 0; v < kMaxRowTiles; ++v) {
      const int t = warp + v * kWarps;
      if (t < nrt) {
        const int i0 = kTile * (t / nnb), nb = t % nnb, n0 = kTile * nb;
        Acc acc;
        zero(acc);
        warp_mma<kSplit, true, false>(acc, dy_s + (size_t)i0 * ldp, ldp,
                                      pv_s + n0, ldn, d.pp);
        float(&cv)[MT][NT][4] = dc[v];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = i0 + acc_row(mt, e);
              const int n = n0 + acc_col<true>(nt, e);
              const float o = acc[mt][nt][e] * ecs[i];
              cv[mt][nt][e] += o;
              acc[mt][nt][e] = o * to_float(C_s[(size_t)i * ldn + n]);
            }
        store_row_sums(acc, part + nb * d.ckp + i0);
      }
    }
    __syncthreads();
    for (int i = tid; i < ck; i += kThreads) {
      float s = 0.f;
      for (int nb = 0; nb < nnb; ++nb) s += part[nb * d.ckp + i];
      dcs_s[u * d.ckp + i] += s;
    }
  }
  allow_next_grid();
  __syncthreads();
  for (int e = tid; e < nh * d.ckp; e += kThreads) {
    const int u = e / d.ckp, i = e % d.ckp;
    if (i < ck)
      dcs_g[((size_t)b * H + h0 + u) * l + (size_t)c * ck + i] = dcs_s[e];
  }
  // dC summed over the cluster: written, or its cluster partial
  float* stg_c = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int u = 0; u < kMaxRowTiles; ++u) {
    const int t = warp + u * kWarps;
    if (t < nrt)
      stage_tile<true>(dc[u], stg_c, ldf, kTile * (t / nnb),
                       kTile * (t % nnb));
  }
  float* stg_b = reinterpret_cast<float*>(smem + L.staging);
#pragma unroll
  for (int u = 0; u < kMaxRowTiles; ++u) {
    const int t = warp + u * kWarps;
    if (t < nrt)
      stage_tile<true>(db[u], stg_b, ldf, kTile * (t / nnb),
                       kTile * (t % nnb));
  }
  cluster.sync();
  cluster_reduce(cluster, stg_c, ldf, ck, N, [&](int i, int n, float s) {
    if (ncl == 1)
      store_as(&dC[(t0 + i) * N + n], s);
    else
      dcp_g[((t0 + i) * ncl + k_cl) * N + n] = s;
  });
  cluster_reduce(cluster, stg_b, ldf, ck, N, [&](int i, int n, float s) {
    dbd_g[((t0 + i) * ncl + k_cl) * N + n] = s;
  });
  cluster.sync();
}

// (b) state_backward: grid (ceil(P N / 256), H, b); one thread an element
// of one (row, head)'s state; the loads of U chunks in flight together
template <typename T>
__global__ void __launch_bounds__(kThreads) state_backward_kernel(
    const T* __restrict__ dfinal, const T* __restrict__ prev,
    const float* __restrict__ cs_g, float* __restrict__ ds_g,
    float* __restrict__ dot_g, T* __restrict__ dinit, int nc, int l, int H,
    int P, int N, int ck) {
  constexpr int U = 8;
  __shared__ float red[U][kWarps];
  const int h = blockIdx.y, b = blockIdx.z, blk = blockIdx.x;
  const int nblk = gridDim.x, tid = threadIdx.x;
  const int PN = P * N;
  const int e = blk * kThreads + tid;
  const bool in = e < PN;
  const size_t bh = (size_t)b * H + h;
  auto at = [&](int c) { return (((size_t)b * nc + c) * H + h) * PN + e; };
  float g = in && dfinal != nullptr ? to_float(dfinal[bh * PN + e]) : 0.f;
  allow_next_grid();  // (c)'s CTAs need whole SMs: they start as these end
  wait_prior_grid();
  for (int c1 = nc - 1; c1 >= 0; c1 -= U) {  // chunks c1, c1 - 1, ...
    float dprev[U], pv[U], E[U], dot[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c1 - u;
      const bool ok = c >= 0 && in;
      dprev[u] = ok ? ds_g[at(c)] : 0.f;
      pv[u] = ok ? to_float(prev[at(c)]) : 0.f;
      E[u] = c >= 0 ? expf(cs_g[bh * l + (size_t)c * ck + ck - 1]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c1 - u;
      dot[u] = g * pv[u];
      if (c >= 0) {
        if (in) ds_g[at(c)] = g;  // dS_c in dprev_c's place
        g = g * E[u] + dprev[u];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float s = warp_sum(dot[u]);
      if (tid % 32 == 0) red[u][tid / 32] = s;
    }
    __syncthreads();
    if (tid < U && c1 - tid >= 0) {
      float tot = 0.f;
      for (int w = 0; w < kWarps; ++w) tot += red[tid][w];
      dot_g[(bh * nc + c1 - tid) * nblk + blk] = tot;
    }
    __syncthreads();
  }
  if (in) store_as(&dinit[bh * PN + e], g);
}

// (c) ssd_bwd_local: the grid and clusters of (a)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_local_kernel(
    const T* __restrict__ x, const T* __restrict__ dt,
    const T* __restrict__ A, const T* __restrict__ Bm,
    const float* __restrict__ cs_g, const float* __restrict__ ds_g,
    const float* __restrict__ dot_g, const float* __restrict__ dxd_g,
    const float* __restrict__ dcs_g, float* __restrict__ dbd_g,
    float* __restrict__ dap_g, T* __restrict__ dB, T* __restrict__ dx,
    T* __restrict__ ddt, int nblk, int l, int H, int P, int N, int ck,
    int g) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kSplit = sizeof(T) == 4 ? 3 : 1;
  constexpr int es = sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  const Dims d = make_dims(ck, N, P);
  const LocalLayout L = local_layout(d, es, g);
  const int q = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y, ncl = gridDim.x / (int)cluster.num_blocks();
  const int k_cl = q / (int)cluster.num_blocks();
  const int h0 = q * g, nh = max(0, min(g, H - h0));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t t0 = (size_t)b * l + (size_t)c * ck;
  const int npb = d.pp / kTile, nnb = d.np / kTile;
  const int ldn = row_ld(d.np, es), ldp = row_ld(d.pp, es);
  const int lds = row_ld(d.np, 4);
  const T* B_s = reinterpret_cast<const T*>(smem);
  float* dt_s = reinterpret_cast<float*>(smem + L.dt);
  float* w_s = reinterpret_cast<float*>(smem + L.w);
  float* dcs_s = reinterpret_cast<float*>(smem + L.dcs);
  float* head_s = reinterpret_cast<float*>(smem + L.head);
  float* wdw_s = reinterpret_cast<float*>(smem + L.wdw);
  float* ddt_s = reinterpret_cast<float*>(smem + L.ddt);
  float* wd_part = reinterpret_cast<float*>(smem + L.wd_part);
  float* dd_part = reinterpret_cast<float*>(smem + L.dd_part);
  const size_t ds_bytes = tile_bytes(d.pp, d.np, 4);
  auto stage = [&](int s) { return smem + L.st + s * L.stage; };
  auto load_dS = [&](int u) {  // float32
    load_tile(reinterpret_cast<float*>(stage(u & 1)),
              ds_g + (((size_t)b * nc + c) * H + h0 + u) * P * N, N, P, N,
              d.pp, d.np);
  };
  auto load_x = [&](int u) {
    load_tile(reinterpret_cast<T*>(stage(u & 1) + ds_bytes),
              x + t0 * H * P + (size_t)(h0 + u) * P, (size_t)H * P, ck, P,
              d.ckp, d.pp);
  };

  // B, the first head's x and per head dt and w (the call's inputs), then,
  // once the kernels before have finished, the first head's dS, (a)'s dcs,
  // and E <dS, prev> summed over the state passing's CTAs (one warp a
  // head, in a fixed order) and A
  load_tile(const_cast<T*>(B_s), Bm + t0 * N, N, ck, N, d.ckp, d.np);
  if (nh > 0) load_x(0);
  for (int e = tid; e < g * d.ckp; e += kThreads) {
    const int u = e / d.ckp, i = e % d.ckp;
    const bool in = u < nh && i < ck;
    const size_t at = ((size_t)b * H + h0 + u) * l + (size_t)c * ck;
    dt_s[e] = in ? to_float(dt[(t0 + i) * H + h0 + u]) : 0.f;
    w_s[e] = in ? expf(cs_g[at + ck - 1] - cs_g[at + i]) : 0.f;
  }
  wait_prior_grid();
  if (nh > 0) load_dS(0);
  cp_async_commit();
  for (int e = tid; e < g * d.ckp; e += kThreads) {
    const int u = e / d.ckp, i = e % d.ckp;
    const size_t at = ((size_t)b * H + h0 + u) * l + (size_t)c * ck;
    dcs_s[e] = u < nh && i < ck ? dcs_g[at + i] : 0.f;
  }
  for (int u = warp; u < nh; u += kWarps) {
    const size_t bh = (size_t)b * H + h0 + u;
    float dot = 0.f;
    for (int k = lane; k < nblk; k += 32)
      dot += dot_g[(bh * nc + c) * nblk + k];
    dot = warp_sum(dot);
    if (lane == 0) {
      head_s[2 * u] = expf(cs_g[bh * l + (size_t)c * ck + ck - 1]) * dot;
      head_s[2 * u + 1] = to_float(A[h0 + u]);
    }
  }

  // pass 3, head by head: dS B^T gives dxd (with (a)'s share), dx and ddt's
  // sum over p; x . (dS B) gives wdw; w dt x^T dS is summed over the heads
  // in dbl (dB's local share)
  Acc dbl[kMaxRowTiles];
#pragma unroll
  for (int u = 0; u < kMaxRowTiles; ++u) zero(dbl[u]);
  const int nrt = d.S * nnb;
  for (int u = 0; u < nh; ++u) {
    if (u + 1 < nh) {
      load_dS(u + 1);
      load_x(u + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int h = h0 + u;
    const float* dS_s = reinterpret_cast<const float*>(stage(u & 1));
    const T* x_s = reinterpret_cast<const T*>(stage(u & 1) + ds_bytes);
    const float* w = w_s + u * d.ckp;
    const float* dtu = dt_s + u * d.ckp;
    for (int t = warp; t < d.S * npb; t += kWarps) {
      const int j0 = kTile * (t / npb), pb = t % npb, p0 = kTile * pb;
      Acc old, acc;
      for_pairs<false>(old, [&](int rr, int cc, float& v0, float& v1) {
        const int j = j0 + rr, p = p0 + cc;
        const float2 o = j < ck ? load_pair(dxd_g + ((t0 + j) * H + h) * P + p,
                                            p, P)
                                : make_float2(0.f, 0.f);
        v0 = o.x;
        v1 = o.y;
      });
      zero(acc);
      warp_mma<kSplit, true, true>(acc, B_s + (size_t)j0 * ldn, ldn,
                                   dS_s + (size_t)p0 * lds, lds, d.np);
      // old: dxd . x; acc: x . (dS B)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + acc_row(mt, e);
            const int p = p0 + acc_col<false>(nt, e);
            const float xv = to_float(x_s[(size_t)j * ldp + p]);
            const float dxd = old[mt][nt][e] + w[j] * acc[mt][nt][e];
            old[mt][nt][e] = dxd;
            acc[mt][nt][e] *= xv;
          }
      for_pairs<false>(old, [&](int rr, int cc, float& v0, float& v1) {
        const int j = j0 + rr, p = p0 + cc;
        if (j < ck)
          store_pair(dx + ((t0 + j) * H + h) * P + p, p, P, v0 * dtu[j],
                     v1 * dtu[j]);
      });
      for_each<false>(old, [&](int j, int p, float& v) {
        v *= to_float(x_s[(size_t)(j0 + j) * ldp + p0 + p]);
      });
      store_row_sums(old, dd_part + pb * d.ckp + j0);
      store_row_sums(acc, wd_part + pb * d.ckp + j0);
    }
    // dB_j += w_j dt_j x_j^T dS (ck x N)
#pragma unroll
    for (int v = 0; v < kMaxRowTiles; ++v) {
      const int t = warp + v * kWarps;
      if (t < nrt) {
        const int j0 = kTile * (t / nnb), n0 = kTile * (t % nnb);
        warp_mma<kSplit, true, false>(
            dbl[v], x_s + (size_t)j0 * ldp, ldp, dS_s + n0, lds, d.pp,
            [&](int m, int, float v) {
              return v * w[j0 + m] * dtu[j0 + m];
            });
      }
    }
    __syncthreads();
    for (int j = tid; j < d.ckp; j += kThreads) {
      float s = 0.f, t = 0.f;
      for (int pb = 0; pb < npb; ++pb) {
        s += wd_part[pb * d.ckp + j];
        t += dd_part[pb * d.ckp + j];
      }
      wdw_s[u * d.ckp + j] = w[j] * dtu[j] * s;
      ddt_s[u * d.ckp + j] = t;
    }
  }
  cp_async_wait<0>();  // B's copy, where no head ran
  __syncthreads();

  // pass 5, one warp a head: dcs (with (a)'s share, wdw and cs_last's),
  // its reverse cumulative sum d(dt A), ddt, and dA's share of the chunk
  for (int u = warp; u < nh; u += kWarps) {
    const int h = h0 + u;
    const float* wdw = wdw_s + u * d.ckp;
    float tw = 0.f;
    for (int i = lane; i < ck; i += 32) tw += wdw[i];
    tw = warp_sum(tw);
    const float dlast = tw + head_s[2 * u];
    const float a_h = head_s[2 * u + 1];
    float carry = 0.f, da_sum = 0.f;
    for (int base = (ck - 1) / 32 * 32; base >= 0; base -= 32) {
      const int i = base + lane;
      float s = 0.f;
      if (i < ck) {
        s = dcs_s[u * d.ckp + i] - wdw[i];
        if (i == ck - 1) s += dlast;
      }
      // suffix sum within the 32 positions, then the later blocks' total
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_down_sync(0xffffffffu, s, o);
        if (lane + o < 32) s += y;
      }
      s += carry;
      carry = __shfl_sync(0xffffffffu, s, 0);
      if (i < ck) {
        store_as(&ddt[(t0 + i) * H + h], ddt_s[u * d.ckp + i] + a_h * s);
        da_sum += dt_s[u * d.ckp + i] * s;
      }
    }
    da_sum = warp_sum(da_sum);
    if (lane == 0) dap_g[((size_t)b * nc + c) * H + h] = da_sum;
  }

  allow_next_grid();
  // dB = the cluster's sum of the local shares plus (a)'s: written, or its
  // cluster partial in place of (a)'s
  float* stg = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int u = 0; u < kMaxRowTiles; ++u) {
    const int t = warp + u * kWarps;
    if (t < nrt)
      stage_tile<true>(dbl[u], stg, lds, kTile * (t / nnb),
                       kTile * (t % nnb));
  }
  cluster_sum(cluster, stg, lds, ck, N, [&](int i, int n, float s) {
    float* at = dbd_g + ((t0 + i) * ncl + k_cl) * N + n;
    const float v = s + *at;
    if (ncl == 1)
      store_as(&dB[(t0 + i) * N + n], v);
    else
      *at = v;
  });
}

// (d) ssd_bwd_sum: dA (H,) over the (b, chunks) partials and, with
// `clusters` > 1, dB and dC (b, l, N) over the clusters' partials; one
// thread an output element
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_sum_kernel(
    const float* __restrict__ dbd, const float* __restrict__ dcp,
    const float* __restrict__ dap, T* __restrict__ dB, T* __restrict__ dC,
    T* __restrict__ dA, size_t rows, int clusters, int H, int N, int bc) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  wait_prior_grid();
  if (idx < (size_t)H) {
    float s = 0.f;
    for (int k = 0; k < bc; ++k) s += dap[(size_t)k * H + idx];
    store_as(&dA[idx], s);
    return;
  }
  if (clusters == 1) return;
  const size_t per = rows * N, e0 = idx - H;
  if (e0 >= 2 * per) return;
  const bool is_c = e0 >= per;
  const size_t e = is_c ? e0 - per : e0;
  const size_t row = e / N, n = e % N;
  const float* src = (is_c ? dcp : dbd) + row * clusters * N + n;
  float s = 0.f;
  for (int k = 0; k < clusters; ++k) s += src[(size_t)k * N];
  store_as(&(is_c ? dC : dB)[e], s);
}

template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *x, *dt, *A, *Bm, *Cm, *dy, *dfinal, *cs, *prev;
  void *dx, *ddt, *dA, *dB, *dC, *dinit;
  float *ds, *dxd, *dcs, *dot, *dap, *dbd, *dcp;
  int b, l, H, P, N, ck, group, cluster, clusters;
};

// Launch `kernel` on `grid` of kThreads-thread CTAs: in clusters of
// `cluster` CTAs along x where cluster > 0, and as a programmatic dependent
// of the kernel before it in the stream where `after` (see
// wait_prior_grid).
template <typename K, typename... Xs>
cudaError_t launch_ex(K kernel, dim3 grid, int cluster, bool after,
                      size_t smem, cudaStream_t stream, Xs... xs) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (cluster > 0) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (after) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, xs...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  if (a.b <= 0 || a.l <= 0 || a.H <= 0 || a.P <= 0 || a.N <= 0 ||
      a.N > kMaxN || a.ck <= 0 || a.ck > kMaxCk || a.l % a.ck != 0 ||
      a.group < 1 || a.group > kMaxGroup || a.cluster < 1 ||
      a.cluster > kMaxCluster || a.clusters < 1 ||
      (long)a.clusters * a.cluster * a.group < a.H ||
      (a.clusters > 1 && a.dcp == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nc = a.l / a.ck;
  const Dims d = make_dims(a.ck, a.N, a.P);
  const size_t s_a = chunk_layout(d, sizeof(T), a.group).total;
  const size_t s_c = local_layout(d, sizeof(T), a.group).total;
  cudaError_t err;
  if ((err = raise_smem(ssd_bwd_chunk_kernel<T>, s_a)) ||
      (err = raise_smem(ssd_bwd_local_kernel<T>, s_c)))
    return (int)err;
  const dim3 grid(a.clusters * a.cluster, nc, a.b);
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* prev = static_cast<const T*>(a.prev);
  const float* cs = static_cast<const float*>(a.cs);
  err = launch_ex(ssd_bwd_chunk_kernel<T>, grid, a.cluster, false, s_a, stream,
                  x, dt, Bm, static_cast<const T*>(a.Cm),
                  static_cast<const T*>(a.dy), prev, cs, a.ds, a.dxd, a.dcs,
                  a.dbd, a.dcp, static_cast<T*>(a.dC), a.l, a.H, a.P, a.N,
                  a.ck, a.group);
  if (err) return (int)err;
  const int nblk = dot_partials(a.P, a.N);
  err = launch_ex(state_backward_kernel<T>, dim3(nblk, a.H, a.b), 0, true, 0,
                  stream, static_cast<const T*>(a.dfinal), prev, cs, a.ds,
                  a.dot, static_cast<T*>(a.dinit), nc, a.l, a.H, a.P, a.N,
                  a.ck);
  if (err) return (int)err;
  err = launch_ex(ssd_bwd_local_kernel<T>, grid, a.cluster, true, s_c, stream,
                       x, dt, static_cast<const T*>(a.A), Bm, cs,
                       static_cast<const float*>(a.ds),
                       static_cast<const float*>(a.dot),
                       static_cast<const float*>(a.dxd),
                       static_cast<const float*>(a.dcs), a.dbd, a.dap,
                       static_cast<T*>(a.dB), static_cast<T*>(a.dx),
                       static_cast<T*>(a.ddt), nblk, a.l, a.H, a.P, a.N, a.ck,
                       a.group);
  if (err) return (int)err;
  const size_t rows = (size_t)a.b * a.l;
  const size_t total = a.H + (a.clusters > 1 ? 2 * rows * a.N : 0);
  return (int)launch_ex(
      ssd_bwd_sum_kernel<T>,
      dim3((unsigned)((total + kThreads - 1) / kThreads)), 0, true, 0, stream,
      static_cast<const float*>(a.dbd), static_cast<const float*>(a.dcp),
      static_cast<const float*>(a.dap), static_cast<T*>(a.dB),
      static_cast<T*>(a.dC), static_cast<T*>(a.dA), rows, a.clusters, a.H,
      a.N, a.b * nc);
}

template <typename K>
int active_clusters(K kernel, int cluster, size_t smem) {
  cudaError_t err = raise_smem(kernel, smem);
  if (err) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * kMaxCluster, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err ? -(int)err : n;
}

template <typename T>
int max_ctas(int cluster, int ck, int N, int P) {
  if (cluster < 1 || cluster > kMaxCluster || ck <= 0 || ck > kMaxCk ||
      N <= 0 || N > kMaxN || P <= 0)
    return -(int)cudaErrorInvalidValue;
  const Dims d = make_dims(ck, N, P);
  const int a = active_clusters(ssd_bwd_chunk_kernel<T>, cluster,
                                chunk_layout(d, sizeof(T), kMaxGroup).total);
  const int c = active_clusters(ssd_bwd_local_kernel<T>, cluster,
                                local_layout(d, sizeof(T), kMaxGroup).total);
  if (a < 0) return a;
  if (c < 0) return c;
  return cluster * (a < c ? a : c);
}

}  // namespace
}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/ssd_scan.py. Tensors are
// contiguous, of one element type (dtype code of common.cuh) unless said:
// x, dy (b,l,H,P), dt (b,l,H), A (H,), B, C (b,l,N), dfinal (b,H,P,N) or
// null for zeros; the forward's float32 cs (b,H,l) and prev (b,l/ck,H,P,N).
// Outputs dx (b,l,H,P), ddt (b,l,H), dA (H,), dB, dC (b,l,N), dinit
// (b,H,P,N). Float32 scratch: ds (b,l/ck,H,P,N), dxd (b,l,H,P), dcs
// (b,H,l), dot (b,H,l/ck,D) with D from ssd_scan_backward_dot_partials, dap
// (b,l/ck,H), dbd (b,l,clusters,N), and dcp (b,l,clusters,N) where
// clusters > 1, else null. group, cluster, clusters: heads a CTA, CTAs a
// cluster, clusters a (row, chunk) (kernels/ssd_scan.py::backward_plan).
// Four launches on ``stream``. Returns a cudaError_t code (0 = launched).
extern "C" int ssd_scan_backward(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dfinal, const void* cs,
    const void* prev, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* dinit, void* ds, void* dxd, void* dcs, void* dot, void* dap,
    void* dbd, void* dcp, int b, int l, int H, int P, int N, int ck,
    int group, int cluster, int clusters, int dtype, void* stream) {
  using namespace repro_torch;
  Args a{x,      dt,     A,        Bm,       Cm,
         dy,     dfinal, cs,       prev,     dx,
         ddt,    dA,     dB,       dC,       dinit,
         static_cast<float*>(ds),  static_cast<float*>(dxd),
         static_cast<float*>(dcs), static_cast<float*>(dot),
         static_cast<float*>(dap), static_cast<float*>(dbd),
         static_cast<float*>(dcp), b,        l,
         H,      P,      N,        ck,       group,
         cluster, clusters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(a, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory bytes the larger of the two chunk kernels needs at g heads
// a CTA.
extern "C" int ssd_scan_backward_smem_bytes(int ck, int N, int P, int group,
                                            int dtype) {
  using namespace repro_torch;
  const Dims d = make_dims(ck, N, P);
  const int es = dtype == kBFloat16 ? 2 : 4;
  return (int)max2(chunk_layout(d, es, group).total,
                   local_layout(d, es, group).total);
}

// The CTAs of the two chunk kernels the card runs at once in clusters of
// `cluster` (the smaller of the two, at the widest head group), or a
// negative cudaError_t code.
extern "C" int ssd_scan_backward_max_ctas(int cluster, int ck, int N, int P,
                                          int dtype) {
  using namespace repro_torch;
  if (dtype == kFloat32) return max_ctas<float>(cluster, ck, N, P);
  if (dtype == kBFloat16) return max_ctas<__nv_bfloat16>(cluster, ck, N, P);
  return -(int)cudaErrorInvalidValue;
}

// The last axis of the dot scratch: state_backward's CTAs a (row, head).
extern "C" int ssd_scan_backward_dot_partials(int P, int N) {
  return repro_torch::dot_partials(P, N);
}

extern "C" const char* ssd_scan_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
