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
// cast); exp is only ever taken of cs_i - cs_j with i >= j and of cs_last -
// cs_j (cs falls), so nothing overflows.
//
// What bounds it on the H100: at mamba2-370m's training shape (4 rows of
// 1,024 tokens, 32 heads of 64, state 128, chunk 128) the products above
// come to ~15 GFLOP (the triangles' pairs on and below the diagonal; C B^T
// once a row and chunk, as B and C are shared by every head), 0.23 ms at
// 67 TFLOP/s of float32 FMA, against ~0.15 GB that the function moves
// (inputs, the forward's states, gradients), 0.04 ms at 3.35 TB/s. On the
// tensor cores the same products take 0.09 ms in float32 (three TF32
// products each, below) and 0.015 ms in bf16 (one), where the bytes bound
// the work (0.02 ms). The design adds the float32 per-head partials of dB
// and dC, ~0.27 GB written and read (0.08 ms); what holds the kernel back
// is latency: a CTA's phases (loads, products, the partials' read and
// write) run one after the other at one CTA an SM.
//
// What the design does: five launches, every product on the tensor cores
// (mma.sync m16n8k8, TF32 with float32 accumulation; float32 splits each
// operand into two TF32 halves, three products, within float32's 1e-4 bar;
// bf16 inputs are exact in TF32 and take one), operands widened to float32
// as they load:
//  (a) chunk_dstate, one CTA per (chunk, head, row): pass 1 (C, dy scaled
//      by exp(cs) and prev in shared memory). dprev into a float32 scratch
//      (b, chunks, H, P, N), dC into the float32 per-head partials
//      (b, l, H, N), dcs into a float32 scratch (b, H, l).
//  (b) state_backward, one thread per (row, head, p, n): walks the chunks
//      from the last (the loads of 8 chunks in flight together),
//      overwrites each chunk's dprev with dS_c, writes dinitial; each CTA
//      (256 elements of one (row, head)) sums its share of <dS_c, prev_c>
//      in a fixed order into a partial per chunk.
//  (c) chunk_local, one CTA per (chunk, head, row): pass 3 (dS_c, B and xd
//      in shared memory). dxd into a float32 scratch (b, l, H, P), dB into
//      its partials, wdw out of dcs and into dcs_last with the partials
//      of (b).
//  (d) chunk_diag, one CTA per (chunk, head, row): pass 4 and 5. C B^T on
//      the 32 x 32 blocks on and below the diagonal in registers, masked
//      and scaled by L into shared memory (in B's place); then P^T dy plus
//      (c)'s dxd gives dx and ddt's sum over p; dy xd^T on the same blocks
//      gives P o dy xd^T's row and column sums and M, which takes P's
//      place; M^T C is added to dB's partials, then B is loaded again in
//      C's place and M B is added to dC's. Last the chunk's reverse
//      cumulative sum, ddt, and the chunk's share of dA.
//  (e) reduce_heads: dB and dC summed over the heads and dA over rows and
//      chunks, each in one fixed order (no atomics anywhere, so two calls
//      are bitwise equal).
// Products are dealt out by 32 x 32 output tile, one warp's (4 x 2 tiles
// of the m16n8 accumulator layout, 32 accumulators a lane): each k-step
// loads an A fragment that feeds four products and a B fragment that feeds
// two. Tiles load 16 bytes (8 in bf16) at a time, several loads in flight;
// the epilogues store pairs. A tile's row and column sums go through
// shuffles and a small array per column or row block, summed in order.
// Shared memory, float32 rows padded by 16 bytes: (d) holds C, B (or P, M),
// dy and xd, 211,456 bytes at chunk 128, state 128 and head dim 64 (one CTA
// an SM); (a) and (c) ~139 KB. The wrapper checks the largest against the
// card's limit. Ragged chunks (ck not a multiple of 32), ragged P and N are
// zero-padded to 32; ck <= 128, N <= 128.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

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

__host__ __device__ inline int pad32(int x) { return (x + 31) / 32 * 32; }
__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Padded sizes and float row strides (16 bytes past the padded width)
struct Dims {
  int ckp, np, pp, ldn, ldp, ldg;
};

__host__ __device__ inline Dims make_dims(int ck, int N, int P) {
  Dims d;
  d.ckp = pad32(ck);
  d.np = pad32(N);
  d.pp = pad32(P);
  d.ldn = d.np + 4;
  d.ldp = d.pp + 4;
  d.ldg = d.ckp + 4;
  return d;
}

// Shared-memory offsets (bytes) of each kernel's arrays.
struct DstateLayout {
  size_t c, dy, s, part, ecs, total;
};
__host__ __device__ inline DstateLayout dstate_layout(const Dims& d) {
  DstateLayout L;
  size_t o = 0;
  L.c = o;
  o += align16((size_t)d.ckp * d.ldn * 4);
  L.dy = o;
  o += align16((size_t)d.ckp * d.ldp * 4);
  L.s = o;
  o += align16((size_t)d.pp * d.ldn * 4);
  L.part = o;  // (np / 32) x ckp: dcs's partial a column block
  o += align16((size_t)(d.np / kTile) * d.ckp * 4);
  L.ecs = o;
  o += align16((size_t)d.ckp * 4);
  L.total = o;
  return L;
}

struct LocalLayout {
  size_t g, b, xd, part, w, wdw, total;
};
__host__ __device__ inline LocalLayout local_layout(const Dims& d) {
  LocalLayout L;
  size_t o = 0;
  L.g = o;
  o += align16((size_t)d.pp * d.ldn * 4);
  L.b = o;
  o += align16((size_t)d.ckp * d.ldn * 4);
  L.xd = o;
  o += align16((size_t)d.ckp * d.ldp * 4);
  L.part = o;  // (pp / 32) x ckp: xd . (dS B)'s partial a column block
  o += align16((size_t)(d.pp / kTile) * d.ckp * 4);
  L.w = o;
  o += align16((size_t)d.ckp * 4);
  L.wdw = o;
  o += align16((size_t)d.ckp * 4);
  L.total = o;
  return L;
}

struct DiagLayout {
  size_t c, bp, dy, xd, cs, dt, row_q, col_q, ddt, dcs, total;
};
__host__ __device__ inline DiagLayout diag_layout(const Dims& d) {
  DiagLayout L;
  size_t o = 0;
  L.c = o;  // C, later B
  o += align16((size_t)d.ckp * d.ldn * 4);
  L.bp = o;  // B, then P, then M
  size_t bp = (size_t)d.ckp * d.ldn * 4;
  if ((size_t)d.ckp * d.ldg * 4 > bp) bp = (size_t)d.ckp * d.ldg * 4;
  o += align16(bp);
  L.dy = o;
  o += align16((size_t)d.ckp * d.ldp * 4);
  L.xd = o;
  o += align16((size_t)d.ckp * d.ldp * 4);
  L.cs = o;
  o += align16((size_t)d.ckp * 4);
  L.dt = o;
  o += align16((size_t)d.ckp * 4);
  L.row_q = o;  // (ckp / 32) x ckp: row sums of P o dy xd^T a column block
  o += align16((size_t)(d.ckp / kTile) * d.ckp * 4);
  L.col_q = o;  // (ckp / 32) x ckp: column sums a row block
  o += align16((size_t)(d.ckp / kTile) * d.ckp * 4);
  L.ddt = o;  // (pp / 32) x ckp: dxd . x's partial a column block
  o += align16((size_t)(d.pp / kTile) * d.ckp * 4);
  L.dcs = o;
  o += align16((size_t)d.ckp * 4);
  L.total = o;
  return L;
}

// Four elements of E as one load, and widened to float32.
template <typename E>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
};
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// rows x cols of src (row stride src_ld, element type E) into the float
// tile dst (row stride ld, a multiple of 4), times scale[r] where scale is
// given; zero up to rows_pad x cols_pad (cols_pad a multiple of 4). Four
// elements a load where the rows allow it, several loads in flight. Call
// __syncthreads() after.
template <typename E>
__device__ void load_rows(float* dst, int ld, const E* __restrict__ src,
                          size_t src_ld, int rows, int cols, int rows_pad,
                          int cols_pad, const float* scale = nullptr) {
  using V = typename Vec4<E>::type;
  if (cols % 4 == 0 && src_ld % 4 == 0 &&
      reinterpret_cast<uintptr_t>(src) % sizeof(V) == 0) {
    const int cq = cols_pad / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < rows_pad * cq; e += kThreads) {
      const int r = e / cq, c = 4 * (e % cq);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && c < cols) {
        v = widen(*reinterpret_cast<const V*>(src + r * src_ld + c));
        if (scale != nullptr) {
          const float s = scale[r];
          v = make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
        }
      }
      *reinterpret_cast<float4*>(dst + (size_t)r * ld + c) = v;
    }
    return;
  }
  for (int e = threadIdx.x; e < rows_pad * cols_pad; e += kThreads) {
    const int r = e / cols_pad, c = e % cols_pad;
    float v = 0.f;
    if (r < rows && c < cols) {
      v = to_float(src[r * src_ld + c]);
      if (scale != nullptr) v *= scale[r];
    }
    dst[(size_t)r * ld + c] = v;
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
// p[0], p[1] += v0, v1 (float32), as store_pair
__device__ __forceinline__ void add_pair(float* p, int col, int W, float v0,
                                         float v1) {
  if (col + 1 < W && W % 2 == 0) {
    float2 o = *reinterpret_cast<float2*>(p);
    *reinterpret_cast<float2*>(p) = make_float2(o.x + v0, o.y + v1);
  } else {
    if (col < W) p[0] += v0;
    if (col + 1 < W) p[1] += v1;
  }
}
// (p[0], p[1]) widened, zeros past W, as store_pair
template <typename E>
__device__ __forceinline__ float2 load_pair(const E* p, int col, int W) {
  return make_float2(col < W ? to_float(p[0]) : 0.f,
                     col + 1 < W ? to_float(p[1]) : 0.f);
}

// A warp's 32 x 32 output tile, as MT x NT tiles of 16 x 8 in the m16n8
// accumulator layout: lane (g, t) = (lane / 4, lane % 4) holds, of tile
// (mt, nt), rows 16 mt + g and + 8, columns 8 nt + 2 t and + 1, as
// c[mt][nt][0] (g, 2t), [1] (g, 2t+1), [2] (g+8, 2t), [3] (g+8, 2t+1).
using Acc = float[MT][NT][4];

__device__ __forceinline__ int acc_row(int mt, int e) {
  return 16 * mt + (threadIdx.x % 32) / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int acc_col(int nt, int e) {
  return 8 * nt + 2 * (threadIdx.x % 4) + (e % 2);
}

// f(row, col, c0, c1) for each pair of accumulators at columns col and
// col + 1 (col even) of row `row` of the warp tile
template <typename F>
__device__ __forceinline__ void for_pairs(Acc& c, F&& f) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        f(acc_row(mt, 2 * hf), acc_col(nt, 0), c[mt][nt][2 * hf],
          c[mt][nt][2 * hf + 1]);
}

__device__ __forceinline__ void zero(Acc& c) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;
}

// c += A (32 x K) B (K x 32) on the tensor cores: A(m, k) is A[m * lda + k]
// when A_K, else A[k * lda + m]; B(k, n) is B[n * ldb + k] when B_K, else
// B[k * ldb + n]. K is a multiple of 8; operands are zero past their data.
// mma.sync m16n8k8 in TF32 with float32 accumulation, each operand's
// fragment loaded from shared memory once a k-step and fed to MT or NT
// products. SPLIT = 3: each operand x = hi + lo (hi = x truncated to TF32,
// lo = x - hi, exact in float32) and lo hi' + hi lo' + hi hi' summed, within
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

template <bool K_MAJOR>
__device__ __forceinline__ float at_k(const float* M, int ld, int row, int k) {
  return K_MAJOR ? M[row * ld + k] : M[k * ld + row];
}

template <bool A_K, bool B_K, int SPLIT>
__device__ __forceinline__ void warp_tile(Acc& c, const float* A, int lda,
                                          const float* B, int ldb, int K) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // rows g, g + 8 at k t; the same at k t + 4
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_tf32<SPLIT>(
            at_k<A_K>(A, lda, 16 * mt + g + 8 * (q % 2), k0 + t + 4 * (q / 2)),
            ah[mt][q], al[mt][q]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];  // column g at k t and t + 4
#pragma unroll
      for (int q = 0; q < 2; ++q)
        split_tf32<SPLIT>(at_k<B_K>(B, ldb, 8 * nt + g, k0 + t + 4 * q),
                          bh[q], bl[q]);
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
// lanes with t == 0 (nt, then the pair, then over t). The whole warp must
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
      if (lane % 4 == 0) out[16 * mt + lane / 4 + 8 * hf] = s;
    }
}

// out[c] = the sum of column c of a warp tile's 32 rows, c < 32, by the
// lanes with g == 0 (mt, then the pair, then over g). The whole warp must
// call it.
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
      if (lane < 4) out[8 * nt + 2 * lane + cc] = s;
    }
}

// Block b of the lower triangle of 32 x 32 blocks: row block I holds
// blocks I (I + 1) / 2 .. I (I + 1) / 2 + I, column blocks 0 .. I.
__device__ __forceinline__ void tri_block(int b, int& I, int& J) {
  I = 0;
  while ((I + 1) * (I + 2) / 2 <= b) ++I;
  J = b - I * (I + 1) / 2;
}

// (a) chunk_dstate: grid (chunks, H, b)
template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_dstate_kernel(
    const T* __restrict__ Cm, const T* __restrict__ dy,
    const T* __restrict__ prev, const float* __restrict__ cs_g,
    float* __restrict__ ds_g, float* __restrict__ dcp_g,
    float* __restrict__ dcs_g, int l, int H, int P, int N, int ck) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kSplit = sizeof(T) == 4 ? 3 : 1;
  const Dims d = make_dims(ck, N, P);
  const DstateLayout L = dstate_layout(d);
  float* C_s = reinterpret_cast<float*>(smem + L.c);
  float* dy_s = reinterpret_cast<float*>(smem + L.dy);
  float* S_s = reinterpret_cast<float*>(smem + L.s);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* ecs = reinterpret_cast<float*>(smem + L.ecs);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x, warp = tid / 32;
  const size_t t0 = (size_t)b * l + (size_t)c * ck;
  const size_t state = (((size_t)b * nc + c) * H + h) * P * N;

  for (int i = tid; i < d.ckp; i += kThreads)
    ecs[i] = i < ck ? expf(cs_g[((size_t)b * H + h) * l + (size_t)c * ck + i])
                    : 0.f;
  __syncthreads();
  load_rows(C_s, d.ldn, Cm + t0 * N, N, ck, N, d.ckp, d.np);
  load_rows(dy_s, d.ldp, dy + t0 * H * P + (size_t)h * P, (size_t)H * P, ck,
            P, d.ckp, d.pp, ecs);  // exp(cs_i) dy_i
  load_rows(S_s, d.ldn, prev + state, N, P, N, d.pp, d.np);
  __syncthreads();

  // dprev (P x N) = (exp(cs) dy)^T C
  const int nnb = d.np / kTile;
  for (int t = warp; t < (d.pp / kTile) * nnb; t += kWarps) {
    const int p0 = kTile * (t / nnb), n0 = kTile * (t % nnb);
    Acc acc;
    zero(acc);
    warp_tile<false, false, kSplit>(acc, dy_s + p0, d.ldp, C_s + n0, d.ldn,
                                    d.ckp);
    for_pairs(acc, [&](int r, int cc, float& v0, float& v1) {
      const int p = p0 + r, n = n0 + cc;
      if (p < P) store_pair(ds_g + state + (size_t)p * N + n, n, N, v0, v1);
    });
  }
  // dC (ck x N) = (exp(cs) dy) prev, and its row dot with C
  for (int t = warp; t < (d.ckp / kTile) * nnb; t += kWarps) {
    const int i0 = kTile * (t / nnb), nb = t % nnb, n0 = kTile * nb;
    Acc acc, v;
    zero(acc);
    warp_tile<true, false, kSplit>(acc, dy_s + (size_t)i0 * d.ldp, d.ldp,
                                   S_s + n0, d.ldn, d.pp);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[mt][nt][e] = acc[mt][nt][e] *
                         C_s[(size_t)(i0 + acc_row(mt, e)) * d.ldn + n0 +
                             acc_col(nt, e)];
    for_pairs(acc, [&](int r, int cc, float& v0, float& v1) {
      const int i = i0 + r, n = n0 + cc;
      if (i < ck)
        store_pair(dcp_g + ((t0 + i) * H + h) * N + n, n, N, v0, v1);
    });
    store_row_sums(v, part + nb * d.ckp + i0);
  }
  __syncthreads();
  for (int i = tid; i < ck; i += kThreads) {
    float s = 0.f;
    for (int nb = 0; nb < nnb; ++nb) s += part[nb * d.ckp + i];
    dcs_g[((size_t)b * H + h) * l + (size_t)c * ck + i] = s;
  }
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

// (c) chunk_local: grid (chunks, H, b)
template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_local_kernel(
    const T* __restrict__ x, const T* __restrict__ dt,
    const T* __restrict__ Bm, const float* __restrict__ cs_g,
    const float* __restrict__ ds_g, const float* __restrict__ dot_g,
    float* __restrict__ dxd_g, float* __restrict__ dbp_g,
    float* __restrict__ dcs_g, int nblk, int l, int H, int P, int N,
    int ck) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kSplit = sizeof(T) == 4 ? 3 : 1;
  const Dims d = make_dims(ck, N, P);
  const LocalLayout L = local_layout(d);
  float* G_s = reinterpret_cast<float*>(smem + L.g);
  float* B_s = reinterpret_cast<float*>(smem + L.b);
  float* xd_s = reinterpret_cast<float*>(smem + L.xd);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* w_s = reinterpret_cast<float*>(smem + L.w);
  float* wdw = reinterpret_cast<float*>(smem + L.wdw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x, warp = tid / 32;
  const size_t t0 = (size_t)b * l + (size_t)c * ck;
  const size_t bh = (size_t)b * H + h;
  const float* cs = cs_g + bh * l + (size_t)c * ck;
  const float last = cs[ck - 1];

  // w_s: dt here, then w = exp(cs_last - cs) once xd is formed
  for (int i = tid; i < d.ckp; i += kThreads)
    w_s[i] = i < ck ? to_float(dt[(t0 + i) * H + h]) : 0.f;
  __syncthreads();
  load_rows(G_s, d.ldn, ds_g + (((size_t)b * nc + c) * H + h) * P * N, N, P,
            N, d.pp, d.np);
  load_rows(B_s, d.ldn, Bm + t0 * N, N, ck, N, d.ckp, d.np);
  load_rows(xd_s, d.ldp, x + t0 * H * P + (size_t)h * P, (size_t)H * P, ck,
            P, d.ckp, d.pp, w_s);  // x dt
  __syncthreads();
  for (int i = tid; i < d.ckp; i += kThreads)
    w_s[i] = i < ck ? expf(last - cs[i]) : 0.f;
  __syncthreads();

  // dS_c B_j (ck x P): dxd_j = w_j (dS_c B_j), and xd_j . (dS_c B_j)
  const int npb = d.pp / kTile, nnb = d.np / kTile;
  for (int t = warp; t < (d.ckp / kTile) * npb; t += kWarps) {
    const int j0 = kTile * (t / npb), pb = t % npb, p0 = kTile * pb;
    Acc acc, v;
    zero(acc);
    warp_tile<true, true, kSplit>(acc, B_s + (size_t)j0 * d.ldn, d.ldn,
                                  G_s + (size_t)p0 * d.ldn, d.ldn, d.np);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[mt][nt][e] = acc[mt][nt][e] *
                         xd_s[(size_t)(j0 + acc_row(mt, e)) * d.ldp + p0 +
                              acc_col(nt, e)];
    for_pairs(acc, [&](int r, int cc, float& v0, float& v1) {
      const int j = j0 + r, p = p0 + cc;
      if (j < ck)
        store_pair(dxd_g + ((t0 + j) * H + h) * P + p, p, P, w_s[j] * v0,
                   w_s[j] * v1);
    });
    store_row_sums(v, part + pb * d.ckp + j0);
  }
  // dB_j = w_j xd_j^T dS_c (ck x N), the first share of dB's partials
  for (int t = warp; t < (d.ckp / kTile) * nnb; t += kWarps) {
    const int j0 = kTile * (t / nnb), n0 = kTile * (t % nnb);
    Acc acc;
    zero(acc);
    warp_tile<true, false, kSplit>(acc, xd_s + (size_t)j0 * d.ldp, d.ldp,
                                   G_s + n0, d.ldn, d.pp);
    for_pairs(acc, [&](int r, int cc, float& v0, float& v1) {
      const int j = j0 + r, n = n0 + cc;
      if (j < ck)
        store_pair(dbp_g + ((t0 + j) * H + h) * N + n, n, N, w_s[j] * v0,
                   w_s[j] * v1);
    });
  }
  __syncthreads();
  float* dcs = dcs_g + bh * l + (size_t)c * ck;
  for (int j = tid; j < ck; j += kThreads) {
    float s = 0.f;
    for (int pb = 0; pb < npb; ++pb) s += part[pb * d.ckp + j];
    wdw[j] = w_s[j] * s;
    dcs[j] -= wdw[j];
  }
  __syncthreads();
  if (tid == 0) {  // cs_last's share, in a fixed order
    float s = 0.f;
    for (int j = 0; j < ck; ++j) s += wdw[j];
    float dot = 0.f;
    for (int k = 0; k < nblk; ++k) dot += dot_g[(bh * nc + c) * nblk + k];
    dcs[ck - 1] += s + expf(last) * dot;
  }
}

// (d) chunk_diag: grid (chunks, H, b)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) chunk_diag_kernel(
    const T* __restrict__ x, const T* __restrict__ dt,
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const T* __restrict__ dy,
    const float* __restrict__ cs_g, const float* __restrict__ dxd_g,
    const float* __restrict__ dcs_g, float* __restrict__ dbp_g,
    float* __restrict__ dcp_g, float* __restrict__ da_g, T* __restrict__ dx,
    T* __restrict__ ddt, int l, int H, int P, int N, int ck) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kSplit = sizeof(T) == 4 ? 3 : 1;
  const Dims d = make_dims(ck, N, P);
  const DiagLayout L = diag_layout(d);
  float* C_s = reinterpret_cast<float*>(smem + L.c);
  float* BP_s = reinterpret_cast<float*>(smem + L.bp);
  float* dy_s = reinterpret_cast<float*>(smem + L.dy);
  float* xd_s = reinterpret_cast<float*>(smem + L.xd);
  float* cs_s = reinterpret_cast<float*>(smem + L.cs);
  float* dt_s = reinterpret_cast<float*>(smem + L.dt);
  float* row_q = reinterpret_cast<float*>(smem + L.row_q);
  float* col_q = reinterpret_cast<float*>(smem + L.col_q);
  float* ddt_p = reinterpret_cast<float*>(smem + L.ddt);
  float* dcs_s = reinterpret_cast<float*>(smem + L.dcs);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32;
  const size_t t0 = (size_t)b * l + (size_t)c * ck;
  const size_t bh = (size_t)b * H + h;
  const int S = d.ckp / kTile, ntri = S * (S + 1) / 2;
  const int npb = d.pp / kTile, nnb = d.np / kTile;

  for (int i = tid; i < d.ckp; i += kThreads) {
    const bool in = i < ck;
    cs_s[i] = in ? cs_g[bh * l + (size_t)c * ck + i] : 0.f;
    dt_s[i] = in ? to_float(dt[(t0 + i) * H + h]) : 0.f;
  }
  // the row and column sums of blocks above the diagonal stay 0
  for (int e = tid; e < S * d.ckp; e += kThreads) row_q[e] = col_q[e] = 0.f;
  __syncthreads();
  load_rows(C_s, d.ldn, Cm + t0 * N, N, ck, N, d.ckp, d.np);
  load_rows(BP_s, d.ldn, Bm + t0 * N, N, ck, N, d.ckp, d.np);
  load_rows(dy_s, d.ldp, dy + t0 * H * P + (size_t)h * P, (size_t)H * P, ck,
            P, d.ckp, d.pp);
  load_rows(xd_s, d.ldp, x + t0 * H * P + (size_t)h * P, (size_t)H * P, ck,
            P, d.ckp, d.pp, dt_s);  // x dt
  __syncthreads();

  // L_ij = exp(cs_i - cs_j) for j <= i < ck, else 0
  auto decay = [&](int i, int j) {
    return (j > i || i >= ck) ? 0.f : expf(cs_s[i] - cs_s[j]);
  };

  // P = (C B^T) o L on the blocks on and below the diagonal, in registers,
  // then in B's place (row stride ldg); a later product reads no block
  // above the diagonal
  Acc r[kMaxTriBlocks];
#pragma unroll
  for (int u = 0; u < kMaxTriBlocks; ++u) {
    const int blk = warp + u * kWarps;
    zero(r[u]);
    if (blk < ntri) {
      int I, J;
      tri_block(blk, I, J);
      warp_tile<true, true, kSplit>(
          r[u], C_s + (size_t)kTile * I * d.ldn, d.ldn,
          BP_s + (size_t)kTile * J * d.ldn, d.ldn, d.np);
    }
  }
  __syncthreads();  // B is consumed
#pragma unroll
  for (int u = 0; u < kMaxTriBlocks; ++u) {
    const int blk = warp + u * kWarps;
    if (blk < ntri) {
      int I, J;
      tri_block(blk, I, J);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = kTile * I + acc_row(mt, e);
            const int j = kTile * J + acc_col(nt, e);
            BP_s[(size_t)i * d.ldg + j] = r[u][mt][nt][e] * decay(i, j);
          }
    }
  }
  __syncthreads();

  // dxd = (c)'s share + P^T dy (rows j, k = i from j's block on): dx, and
  // dxd . x's partial a column block
  for (int t = warp; t < S * npb; t += kWarps) {
    const int j0 = kTile * (t / npb), pb = t % npb, p0 = kTile * pb;
    Acc acc, xv;
    for_pairs(acc, [&](int r, int cc, float& v0, float& v1) {
      const int j = j0 + r, p = p0 + cc;
      const float2 o = j < ck ? load_pair(dxd_g + ((t0 + j) * H + h) * P + p,
                                          p, P)
                              : make_float2(0.f, 0.f);
      v0 = o.x;
      v1 = o.y;
    });
    for_pairs(xv, [&](int r, int cc, float& v0, float& v1) {
      const int j = j0 + r, p = p0 + cc;
      const float2 o = j < ck ? load_pair(x + ((t0 + j) * H + h) * P + p, p,
                                          P)
                              : make_float2(0.f, 0.f);
      v0 = o.x;
      v1 = o.y;
    });
    warp_tile<false, false, kSplit>(
        acc, BP_s + (size_t)j0 * d.ldg + j0, d.ldg,
        dy_s + (size_t)j0 * d.ldp + p0, d.ldp, d.ckp - j0);
    for_pairs(acc, [&](int r, int cc, float& v0, float& v1) {
      const int j = j0 + r, p = p0 + cc;
      if (j < ck)
        store_pair(dx + ((t0 + j) * H + h) * P + p, p, P, v0 * dt_s[j],
                   v1 * dt_s[j]);
    });
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[mt][nt][e] *= acc[mt][nt][e];
    store_row_sums(xv, ddt_p + pb * d.ckp + j0);
  }

  // dy xd^T on the same blocks: P o dy xd^T's row and column sums, and
  // M = (dy xd^T) o L in P's registers
#pragma unroll
  for (int u = 0; u < kMaxTriBlocks; ++u) {
    const int blk = warp + u * kWarps;
    if (blk < ntri) {  // the same blk for the whole warp
      int I, J;
      tri_block(blk, I, J);
      Acc acc;
      zero(acc);
      warp_tile<true, true, kSplit>(
          acc, dy_s + (size_t)kTile * I * d.ldp, d.ldp,
          xd_s + (size_t)kTile * J * d.ldp, d.ldp, d.pp);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = kTile * I + acc_row(mt, e);
            const int j = kTile * J + acc_col(nt, e);
            r[u][mt][nt][e] = acc[mt][nt][e] * decay(i, j);
            acc[mt][nt][e] *= BP_s[(size_t)i * d.ldg + j];
          }
      store_row_sums(acc, row_q + J * d.ckp + kTile * I);
      store_col_sums(acc, col_q + I * d.ckp + kTile * J);
    }
  }
  __syncthreads();  // P is consumed
#pragma unroll
  for (int u = 0; u < kMaxTriBlocks; ++u) {
    const int blk = warp + u * kWarps;
    if (blk < ntri) {
      int I, J;
      tri_block(blk, I, J);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            BP_s[(size_t)(kTile * I + acc_row(mt, e)) * d.ldg + kTile * J +
                 acc_col(nt, e)] = r[u][mt][nt][e];
    }
  }
  __syncthreads();

  // dB += M^T C (rows j, k = i from j's block on)
  for (int t = warp; t < S * nnb; t += kWarps) {
    const int j0 = kTile * (t / nnb), n0 = kTile * (t % nnb);
    Acc acc;
    zero(acc);
    warp_tile<false, false, kSplit>(
        acc, BP_s + (size_t)j0 * d.ldg + j0, d.ldg,
        C_s + (size_t)j0 * d.ldn + n0, d.ldn, d.ckp - j0);
    for_pairs(acc, [&](int r, int cc, float& v0, float& v1) {
      const int j = j0 + r, n = n0 + cc;
      if (j < ck) add_pair(dbp_g + ((t0 + j) * H + h) * N + n, n, N, v0, v1);
    });
  }
  __syncthreads();  // C is consumed: B again in its place
  load_rows(C_s, d.ldn, Bm + t0 * N, N, ck, N, d.ckp, d.np);
  __syncthreads();
  // dC += M B (rows i, k = j up to the end of i's block)
  for (int t = warp; t < S * nnb; t += kWarps) {
    const int i0 = kTile * (t / nnb), n0 = kTile * (t % nnb);
    Acc acc;
    zero(acc);
    warp_tile<true, false, kSplit>(acc, BP_s + (size_t)i0 * d.ldg, d.ldg,
                                   C_s + n0, d.ldn, i0 + kTile);
    for_pairs(acc, [&](int r, int cc, float& v0, float& v1) {
      const int i = i0 + r, n = n0 + cc;
      if (i < ck) add_pair(dcp_g + ((t0 + i) * H + h) * N + n, n, N, v0, v1);
    });
  }

  // dcs, its reverse cumulative sum d(dt A), ddt and the chunk's dA
  for (int i = tid; i < ck; i += kThreads) {
    float s = dcs_g[bh * l + (size_t)c * ck + i];
    for (int jb = 0; jb < S; ++jb) s += row_q[jb * d.ckp + i];
    for (int ib = 0; ib < S; ++ib) s -= col_q[ib * d.ckp + i];
    dcs_s[i] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int i = ck - 1; i >= 0; --i) {
      acc += dcs_s[i];
      dcs_s[i] = acc;
    }
  }
  __syncthreads();
  const float a_h = to_float(A[h]);
  for (int i = tid; i < ck; i += kThreads) {
    float s = 0.f;
    for (int pb = 0; pb < npb; ++pb) s += ddt_p[pb * d.ckp + i];
    store_as(&ddt[(t0 + i) * H + h], s + a_h * dcs_s[i]);
  }
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < ck; ++i) s += dt_s[i] * dcs_s[i];
    da_g[((size_t)b * gridDim.x + c) * H + h] = s;
  }
}

// (e) reduce_heads: dB, dC (b, l, N) over the H heads' partials, dA (H,)
// over the (b, chunks) partials; one thread an output element
template <typename T>
__global__ void __launch_bounds__(kThreads) reduce_heads_kernel(
    const float* __restrict__ dbp, const float* __restrict__ dcp,
    const float* __restrict__ dap, T* __restrict__ dB, T* __restrict__ dC,
    T* __restrict__ dA, size_t rows, int H, int N, int bc) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t per = rows * N;
  if (idx < 2 * per) {
    const bool is_c = idx >= per;
    const size_t e = is_c ? idx - per : idx;
    const size_t row = e / N, n = e % N;
    const float* src = (is_c ? dcp : dbp) + row * H * N + n;
    float s = 0.f;
    for (int h = 0; h < H; ++h) s += src[(size_t)h * N];
    store_as(&(is_c ? dC : dB)[e], s);
  } else if (idx < 2 * per + H) {
    const int h = (int)(idx - 2 * per);
    float s = 0.f;
    for (int k = 0; k < bc; ++k) s += dap[(size_t)k * H + h];
    store_as(&dA[h], s);
  }
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
  float *ds, *dcp, *dbp, *dxd, *dcs, *dot, *dap;
  int b, l, H, P, N, ck;
};

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  if (a.b <= 0 || a.l <= 0 || a.H <= 0 || a.P <= 0 || a.N <= 0 ||
      a.N > kMaxN || a.ck <= 0 || a.ck > kMaxCk || a.l % a.ck != 0)
    return (int)cudaErrorInvalidValue;
  const int nc = a.l / a.ck;
  const Dims d = make_dims(a.ck, a.N, a.P);
  const size_t s_a = dstate_layout(d).total, s_c = local_layout(d).total,
               s_d = diag_layout(d).total;
  cudaError_t err;
  if ((err = raise_smem(chunk_dstate_kernel<T>, s_a)) ||
      (err = raise_smem(chunk_local_kernel<T>, s_c)) ||
      (err = raise_smem(chunk_diag_kernel<T>, s_d)))
    return (int)err;
  const dim3 grid(nc, a.H, a.b);
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const T* dy = static_cast<const T*>(a.dy);
  const T* prev = static_cast<const T*>(a.prev);
  const float* cs = static_cast<const float*>(a.cs);
  chunk_dstate_kernel<T><<<grid, kThreads, s_a, stream>>>(
      Cm, dy, prev, cs, a.ds, a.dcp, a.dcs, a.l, a.H, a.P, a.N, a.ck);
  if ((err = cudaGetLastError())) return (int)err;
  const int nblk = dot_partials(a.P, a.N);
  state_backward_kernel<T><<<dim3(nblk, a.H, a.b), kThreads, 0, stream>>>(
      static_cast<const T*>(a.dfinal), prev, cs, a.ds, a.dot,
      static_cast<T*>(a.dinit), nc, a.l, a.H, a.P, a.N, a.ck);
  if ((err = cudaGetLastError())) return (int)err;
  chunk_local_kernel<T><<<grid, kThreads, s_c, stream>>>(
      x, dt, Bm, cs, a.ds, a.dot, a.dxd, a.dbp, a.dcs, nblk, a.l, a.H, a.P,
      a.N, a.ck);
  if ((err = cudaGetLastError())) return (int)err;
  chunk_diag_kernel<T><<<grid, kThreads, s_d, stream>>>(
      x, dt, static_cast<const T*>(a.A), Bm, Cm, dy, cs, a.dxd, a.dcs, a.dbp,
      a.dcp, a.dap, static_cast<T*>(a.dx), static_cast<T*>(a.ddt), a.l, a.H,
      a.P, a.N, a.ck);
  if ((err = cudaGetLastError())) return (int)err;
  const size_t rows = (size_t)a.b * a.l;
  const size_t total = 2 * rows * a.N + a.H;
  reduce_heads_kernel<T>
      <<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
          a.dbp, a.dcp, a.dap, static_cast<T*>(a.dB), static_cast<T*>(a.dC),
          static_cast<T*>(a.dA), rows, a.H, a.N, a.b * nc);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/ssd_scan.py. Tensors are
// contiguous, of one element type (dtype code of common.cuh) unless said:
// x, dy (b,l,H,P), dt (b,l,H), A (H,), B, C (b,l,N), dfinal (b,H,P,N) or
// null for zeros; the forward's float32 cs (b,H,l) and prev (b,l/ck,H,P,N).
// Outputs dx (b,l,H,P), ddt (b,l,H), dA (H,), dB, dC (b,l,N), dinit
// (b,H,P,N). Float32 scratch: ds (b,l/ck,H,P,N), dcp and dbp (b,l,H,N),
// dxd (b,l,H,P), dcs (b,H,l), dot (b,H,l/ck,D) with D from
// ssd_scan_backward_dot_partials, and dap (b,l/ck,H). Five launches on
// ``stream``. Returns a cudaError_t code (0 = launched).
extern "C" int ssd_scan_backward(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dfinal, const void* cs,
    const void* prev, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* dinit, void* ds, void* dcp, void* dbp, void* dxd, void* dcs,
    void* dot, void* dap, int b, int l, int H, int P, int N, int ck,
    int dtype, void* stream) {
  using namespace repro_torch;
  Args a{x,
         dt,
         A,
         Bm,
         Cm,
         dy,
         dfinal,
         cs,
         prev,
         dx,
         ddt,
         dA,
         dB,
         dC,
         dinit,
         static_cast<float*>(ds),
         static_cast<float*>(dcp),
         static_cast<float*>(dbp),
         static_cast<float*>(dxd),
         static_cast<float*>(dcs),
         static_cast<float*>(dot),
         static_cast<float*>(dap),
         b,
         l,
         H,
         P,
         N,
         ck};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(a, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory bytes the largest of the three tiled kernels needs.
extern "C" int ssd_scan_backward_smem_bytes(int ck, int N, int P) {
  using namespace repro_torch;
  const Dims d = make_dims(ck, N, P);
  size_t m = dstate_layout(d).total;
  if (local_layout(d).total > m) m = local_layout(d).total;
  if (diag_layout(d).total > m) m = diag_layout(d).total;
  return (int)m;
}

// The last axis of the dot scratch: state_backward's CTAs a (row, head).
extern "C" int ssd_scan_backward_dot_partials(int P, int N) {
  return repro_torch::dot_partials(P, N);
}

extern "C" const char* ssd_scan_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
