// Flash attention (prefill) in float32 on Hopper's tensor cores: causal
// and/or sliding-window grouped-query attention, q (B, H, S, D) against
// k, v (B, KH, T, D), query positions right-aligned at offset T - S,
// forward only, any D <= 256. bf16 goes to flash_attention_sm90.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// ::flash_attention_pallas (body _fa_kernel). That kernel runs a grid
// (B, H, S/128, T/128) with the kv-block axis innermost and in order, so
// its VMEM scratch carries the online softmax from one kv block to the
// next; it visits every kv block, masked or not, and asserts that S and T
// are multiples of the block.
//
// What bounds it on the H100: operations. At a 1024-token gemma3-1b prompt
// (D = 256, 4 query heads on 1 kv head) each K/V element feeds hundreds of
// flops. On the CUDA cores the bound is 67 TFLOP/s of float32 FMA; this
// kernel issues its products to the tensor cores instead, three TF32
// products for each float32 one (494.7 TFLOP/s dense TF32), so its own
// bound is 3 x flops / 494.7 TFLOP/s. In practice the time is the chain
// of kv blocks the busiest CTA walks, and on each block the instructions
// that split the operands (below) issue beside the products.
//
// What the design does:
//  * Split-precision TF32 ("3xTF32") on mma.sync m16n8k8: every operand
//    x is written hi + lo, hi = x rounded to TF32 (to nearest, ties away,
//    as cvt.rna.tf32.f32 rounds: one integer add and one mask) and lo =
//    x - hi (exact in float32; the tensor core reads its TF32 part, so
//    lo enters rounded toward zero). Q K^T keeps hi*hi', lo*hi' and
//    hi*lo' in three float32 accumulators (short chains of dependent
//    products), added at the end; P V adds the two small products, then
//    hi*hi', into O's accumulator. The error is that of float32 FMA,
//    within the 2e-5 bar where plain TF32 is not. The softmax, the
//    rescaling and the final division stay in float32 (exp2f on scores
//    scaled by log2(e) / sqrt(D)). Operands are split as fragments are
//    loaded from shared memory, so no tile is held twice.
//  * Fragment orders that need no shuffles: the reduction index of Q K^T
//    is read 16 columns of D at a time, each lane 4 consecutive ones (one
//    16-byte load feeds two k-steps); a score tile's accumulator holds
//    keys 2t and 2t + 1 in lane t of a quad, which is exactly the A
//    fragment of P V when V's rows are taken in the order (2t, 2t + 1);
//    the output columns of P V are interleaved by 4 within 32, so that a
//    lane's V fragments for 4 n-tiles are one 16-byte load and its output
//    is 8 consecutive floats. Row strides of 16 words mod 32 (Q, K) and 4
//    mod 32 (V) keep those 16-byte loads free of bank conflicts.
//  * GQA: the GP = gcd(G, 64) query heads that share a kv head are packed
//    into the CTA's 64 rows (64 / GP positions each), so each K/V tile
//    crosses device memory once for all of them: at gemma3-1b's G = 4 a
//    1024-token prompt is 64 query blocks of 16 positions x 4 heads.
//  * Eight warps: two a group of 16 rows, one for each 16-key half of
//    every kv tile, each with its own online softmax (max, sum, and O in
//    registers, D / 2 floats a lane), so that two warps share each
//    scheduler; the halves merge through shared memory at the end.
//  * Pipelined loads: Q once, then K and V tiles of BK = 32 keys in a ring
//    of two stages, filled by 16-byte cp.async where D % 4 == 0 (4-byte
//    otherwise) while the previous stage is consumed; rows past S or T
//    and columns past D are zero-filled by the copy itself. D is padded to
//    DP = 32, 64, 128 or 256 (one instantiation each). At DP = 256: Q
//    64 x 272, two stages of K 32 x 272 and V 32 x 260 floats, 205,824
//    bytes of the 232,448 a CTA may have.
//  * Only kv blocks that some row of the CTA can see are visited (the
//    causal bound and the window), the heaviest query blocks start first,
//    and the mask is applied only on blocks that straddle the diagonal,
//    the window edge or T.
//  * The row log-sum-exp (float32 (B, H, S), m + log l in the natural log
//    of the scaled scores), which the backward kernel reads, is written
//    only where its pointer is non-null (training); serving passes null.
//  * Split kv range: 1-4 CTAs share a query block's range, as many as
//    make the grid finish first when the SMs take the CTAs in launch order
//    (heaviest query blocks first), and write unnormalised partial rows
//    with their (max, sum); a second kernel merges them in float32. At
//    the 1024 bucket that is 2 (window 512) or 4 (global) CTAs a query
//    block, chains of at most 9 and 8 blocks of 32 keys. (A cluster of
//    CTAs merging through distributed shared memory in one launch was
//    slower on the H100: a 4-CTA cluster of 205 KB CTAs leaves SMs idle,
//    and its merge cost more than the second launch.)

#include <stdint.h>

#include <algorithm>
#include <functional>
#include <queue>
#include <vector>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BM = 64;  // rows of a CTA: four groups of 16
constexpr int BK = 32;  // keys of a K/V tile
constexpr int kWarps = 8;  // two a row group, one a half of each kv tile
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 256;
constexpr int kMaxSplits = 4;

// Shared-memory layout (floats) for D padded to DP.
template <int DP>
struct Layout {
  static constexpr int ldq = DP + 16;  // 16 mod 32
  static constexpr int ldk = DP + 16;
  static constexpr int ldv = DP + 4;   // 4 mod 32
  static constexpr int k = BM * ldq;
  static constexpr int kstage = BK * ldk;
  static constexpr int v = k + 2 * kstage;
  static constexpr int vstage = BK * ldv;
  static constexpr int total = v + 2 * vstage;
};

// The kv blocks [first, first + count) that some row of the query block at
// s0 (rp positions a head) can see: the causal bound and the window.
struct KvBlocks {
  int first, count;
};
__host__ __device__ inline KvBlocks kv_blocks(int s0, int rp, int S, int T_len,
                                              int causal, int window) {
  const int offset = T_len - S;
  const int q_first = s0 + offset;
  const int q_last = (s0 + rp < S ? s0 + rp : S) - 1 + offset;
  const int lo = q_first - window + 1;
  const int k_begin = window > 0 && lo > 0 ? lo : 0;
  const int k_end = causal && q_last + 1 < T_len ? q_last + 1 : T_len;
  return {k_begin / BK, (k_end + BK - 1) / BK - k_begin / BK};
}

// Copies of 16 and 4 bytes from device to shared memory that write zeros
// where `in` is false (no byte is read then).
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src,
                                                 bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows x DP floats of a tile: row i is src_row(i) (nullptr: zeros), columns
// past D are zeros; a zero-filled copy is given `base` as its (unread)
// source. 16-byte copies where vec (D % 4 == 0, 16-byte aligned rows),
// else 4-byte ones.
template <int DP, typename RowPtr>
__device__ __forceinline__ void load_tile(float* dst, int ld, int rows, int D,
                                          bool vec, const float* base,
                                          RowPtr src_row) {
  if (vec) {
    constexpr int C = DP / 4;  // 16-byte chunks a row (a power of two)
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * C; e += kThreads) {
      const int i = e / C, c = 4 * (e % C);
      const float* row = src_row(i);
      const bool in = row != nullptr && c < D;
      cp_async16_zfill(dst + i * ld + c, in ? row + c : base, in);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * DP; e += kThreads) {
      const int i = e / DP, c = e % DP;
      const float* row = src_row(i);
      const bool in = row != nullptr && c < D;
      cp_async4_zfill(dst + i * ld + c, in ? row + c : base, in);
    }
  }
}

// The BK x DP tile of rows k0 .. k0 + BK - 1 of src (rows of D floats),
// zeros past T_len or D, in copies of U floats (4: 16 bytes; 1). A thread
// copies one fixed column of every (kThreads / copies-a-row)-th row, so a
// copy costs an add and a compare: this runs once a kv block.
template <int DP, int U>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, int k0,
                                          int T_len, int D) {
  constexpr int C = DP / U;              // copies a row (at most kThreads)
  constexpr int RSTEP = kThreads / C;    // rows between a thread's copies
  const int c = U * (threadIdx.x % C), r0 = threadIdx.x / C;
  const bool col = c < D;
  const float* s = src + (size_t)(k0 + r0) * D + c;
  float* d = dst + r0 * ld + c;
#pragma unroll
  for (int u = 0; u < BK / RSTEP; ++u) {
    const bool in = col && k0 + r0 + u * RSTEP < T_len;
    const float* from = in ? s + (size_t)u * RSTEP * D : src;
    if (U == 4)
      cp_async16_zfill(d + u * RSTEP * ld, from, in);
    else
      cp_async4_zfill(d + u * RSTEP * ld, from, in);
  }
}

// -- split-precision TF32 -----------------------------------------------------

// x = hi + lo: hi rounded to TF32 (nearest, ties away from zero), lo the
// exact rest, whose low 13 bits the tensor core does not read
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ o_part, float* __restrict__ ml_part,
    float* __restrict__ lse, int H, int KH, int S, int T_len, int D, int GP,
    int causal, int window, float scale_log2, int splits, int vec) {
  using L = Layout<DP>;
  constexpr int NC = DP / 32;  // 32-column groups of the output
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = smem + L::k;
  float* v_s = smem + L::v;

  const int RP = BM / GP;  // query positions a CTA holds per head
  const int rp_shift = __ffs(RP) - 1;  // RP is a power of two
  const int nqb = gridDim.x / splits, part = blockIdx.x % splits;
  const int s0 = (nqb - 1 - blockIdx.x / splits) * RP;  // heaviest first
  const int h0 = blockIdx.y * GP, b = blockIdx.z;
  const int kh = h0 / (H / KH);
  const int offset = T_len - S;
  const int q_first = s0 + offset;
  const int q_last = min(s0 + RP, S) - 1 + offset;
  const KvBlocks all = kv_blocks(s0, RP, S, T_len, causal, window);
  const int per = (all.count + splits - 1) / splits;
  const int kb0 = all.first + part * per;
  const int nblocks = max(0, min(per, all.count - part * per));

  const float* k_g = k + (size_t)(b * KH + kh) * T_len * D;
  const float* v_g = v + (size_t)(b * KH + kh) * T_len * D;
  // row m of the tile: head h0 + m / RP, position s0 + m % RP
  load_tile<DP>(q_s, L::ldq, BM, D, vec, q, [&](int m) -> const float* {
    const int s = s0 + (m & (RP - 1));
    return s < S ? q + ((size_t)(b * H + h0 + (m >> rp_shift)) * S + s) * D
                 : nullptr;
  });
  auto load_kv = [&](int st, int kb) {
    if (vec) {
      load_rows<DP, 4>(k_s + st * L::kstage, L::ldk, k_g, kb * BK, T_len, D);
      load_rows<DP, 4>(v_s + st * L::vstage, L::ldv, v_g, kb * BK, T_len, D);
    } else {
      load_rows<DP, 1>(k_s + st * L::kstage, L::ldk, k_g, kb * BK, T_len, D);
      load_rows<DP, 1>(v_s + st * L::vstage, L::ldv, v_g, kb * BK, T_len, D);
    }
  };
  if (nblocks > 0) load_kv(0, kb0);
  cp_async_commit();

  // warp w: rows 16 (w % 4) .. + 15 of the tile, keys 16 (w / 4) .. + 15
  // of each kv tile, with its own online softmax over them
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % 4, kw = warp / 4;
  const int g = lane / 4, t = lane % 4;
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    qpos[r] = s0 + ((16 * rw + g + 8 * r) & (RP - 1)) + offset;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  float acc[NC][4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
  const float* qw = q_s + 16 * rw * L::ldq;

  for (int i = 0; i < nblocks; ++i) {
    const int st = i & 1;
    if (i + 1 < nblocks) load_kv(st ^ 1, kb0 + i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this block's stage (and Q) have landed
    __syncthreads();
    const float* ks = k_s + st * L::kstage + 16 * kw * L::ldk;
    const float* vs = v_s + st * L::vstage + 16 * kw * L::ldv;

    // S = Q K^T (16 rows x 16 keys a warp): lane t reads columns
    // 16 s + 4 t .. + 3, the k index t of step h being column 4 t + 2 h
    // and t + 4 column 4 t + 2 h + 1
    // three accumulators an n-tile (hi hi', lo hi', hi lo'), so that no
    // chain of dependent products runs longer than 2 a column step
    float big[2][4], sa[2][4], sb[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[j][e] = sa[j][e] = sb[j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < DP / 16; ++s) {
      const float4 qa = *reinterpret_cast<const float4*>(
          qw + g * L::ldq + 16 * s + 4 * t);
      const float4 qb = *reinterpret_cast<const float4*>(
          qw + (g + 8) * L::ldq + 16 * s + 4 * t);
      float4 kf[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kf[j] = *reinterpret_cast<const float4*>(
            ks + (8 * j + g) * L::ldk + 16 * s + 4 * t);
      uint32_t ah[2][4], al[2][4], bh[2][2][2], bl[2][2][2];
      split(qa.x, ah[0][0], al[0][0]);
      split(qb.x, ah[0][1], al[0][1]);
      split(qa.y, ah[0][2], al[0][2]);
      split(qb.y, ah[0][3], al[0][3]);
      split(qa.z, ah[1][0], al[1][0]);
      split(qb.z, ah[1][1], al[1][1]);
      split(qa.w, ah[1][2], al[1][2]);
      split(qb.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        split(kf[j].x, bh[j][0][0], bl[j][0][0]);
        split(kf[j].y, bh[j][0][1], bl[j][0][1]);
        split(kf[j].z, bh[j][1][0], bl[j][1][0]);
        split(kf[j].w, bh[j][1][1], bl[j][1][1]);
      }
      // consecutive products go to different accumulators
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_tf32(sa[j], al[h], bh[j][h]);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_tf32(sb[j], ah[h], bl[j][h]);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_tf32(big[j], ah[h], bh[j][h]);
      }
    }

    // scores in log2 units; the mask only on blocks that need it
    const int k0 = (kb0 + i) * BK;
    const bool full = k0 + BK <= T_len &&
                      (!causal || k0 + BK - 1 <= q_first) &&
                      (window <= 0 || q_last - k0 < window);
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (big[j][e] + (sa[j][e] + sb[j][e])) * scale_log2;
        if (!full) {
          const int kpos = k0 + 16 * kw + 8 * j + 2 * t + (e & 1);
          const int qp = qpos[e >> 1];
          const bool ok = kpos < T_len && (!causal || qp >= kpos) &&
                          (window <= 0 || qp - kpos < window);
          x = ok ? x : kNegInf;
        }
        p[j][e] = x;
      }

    // online softmax: row g holds elements 0, 1, row g + 8 elements 2, 3;
    // a row's 16 keys are spread over the 4 lanes of a quad
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_i[r];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mx = fmaxf(mx, fmaxf(p[j][2 * r], p[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          p[j][e] = exp2f(p[j][e] - mx);
          sum += p[j][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      corr[r] = exp2f(m_i[r] - mx);
      l_i[r] = l_i[r] * corr[r] + sum;
      m_i[r] = mx;
    }
    // a row's max rarely moves once the first blocks are seen: where no
    // row of the warp moved, corr is exactly 1 and the rescale is skipped
    if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][j][e] *= corr[e >> 1];
    }

    // O += P V: k-step j is keys 8 j + (2 t, 2 t + 1), which lane t holds
    // as elements (0, 1) of row g and (2, 3) of row g + 8; n-tile jj of
    // column group c is columns 32 c + 4 n + jj. The small products go
    // first into the same accumulator.
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      split(p[j][0], ph[j][0], pl[j][0]);
      split(p[j][2], ph[j][1], pl[j][1]);
      split(p[j][1], ph[j][2], pl[j][2]);
      split(p[j][3], ph[j][3], pl[j][3]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* vr = vs + (8 * j + 2 * t) * L::ldv + 32 * c + 4 * g;
        const float4 v0 = *reinterpret_cast<const float4*>(vr);
        const float4 v1 = *reinterpret_cast<const float4*>(vr + L::ldv);
        const float b0[4] = {v0.x, v0.y, v0.z, v0.w};
        const float b1[4] = {v1.x, v1.y, v1.z, v1.w};
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          split(b0[jj], bh[jj][0], bl[jj][0]);
          split(b1[jj], bh[jj][1], bl[jj][1]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) mma_tf32(acc[c][jj], pl[j], bh[jj]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) mma_tf32(acc[c][jj], ph[j], bl[jj]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) mma_tf32(acc[c][jj], ph[j], bh[jj]);
      }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  // the two key halves of each row group meet: warps 4..7 hand their
  // (max, sum, O) to warps 0..3 through the (now idle) K/V stages, laid
  // out element-major so that a warp's 32 lanes hit 32 banks
  float* xch = k_s + (16 * NC + 4) * 32 * rw + lane;
  __syncthreads();
  if (kw == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xch[32 * r] = m_i[r];
      xch[32 * (2 + r)] = l_i[r];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xch[32 * (4 + 16 * c + 4 * j + e)] = acc[c][j][e];
  }
  __syncthreads();
  if (kw == 1) return;
  {
    float w0[2], w1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = xch[32 * r], l1 = xch[32 * (2 + r)];
      const float mx = fmaxf(m_i[r], m1);
      w0[r] = exp2f(m_i[r] - mx);
      w1[r] = exp2f(m1 - mx);
      l_i[r] = l_i[r] * w0[r] + l1 * w1[r];
      m_i[r] = mx;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[c][j][e] = acc[c][j][e] * w0[e >> 1] +
                         xch[32 * (4 + 16 * c + 4 * j + e)] * w1[e >> 1];
  }

  // epilogue: O / l, or with a split kv range the unnormalised O and the
  // row's (max, sum) for the merge. Lane (g, t) holds columns
  // 32 c + 8 t + (0..3) (element 0 or 2 of n-tiles 0..3) and
  // 32 c + 8 t + 4 + (0..3) (element 1 or 3); rows past S and columns
  // past D are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = 16 * rw + g + 8 * r;
    const int spos = s0 + (m & (RP - 1));
    if (spos >= S) continue;
    const size_t row = (size_t)(b * H + h0 + (m >> rp_shift)) * S + spos;
    float* dst;
    float inv;
    if (splits == 1) {
      dst = o + row * D;
      inv = 1.f / fmaxf(l_i[r], kMinDenom);
      if (lse != nullptr && t == 0)
        lse[row] = (m_i[r] + log2f(fmaxf(l_i[r], kMinDenom))) * kLn2;
    } else {
      const size_t prow = (size_t)part * gridDim.z * H * S + row;
      dst = o_part + prow * D;
      inv = 1.f;
      if (t == 0)
        *reinterpret_cast<float2*>(ml_part + 2 * prow) =
            make_float2(m_i[r], l_i[r]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 32 * c + 8 * t + 4 * half;
        const int e = 2 * r + half;
        const float x[4] = {acc[c][0][e] * inv, acc[c][1][e] * inv,
                            acc[c][2][e] * inv, acc[c][3][e] * inv};
        if (vec) {
          if (col < D)
            *reinterpret_cast<float4*>(dst + col) =
                make_float4(x[0], x[1], x[2], x[3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (col + u < D) dst[col + u] = x[u];
        }
      }
  }
}

// Merge the splits' partial rows: one warp a row of O (B * H * S rows),
// and the row's log-sum-exp where lse is non-null.
__global__ void __launch_bounds__(256) flash_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ ml_part,
    float* __restrict__ o, float* __restrict__ lse, int rows, int D,
    int splits) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float mx = kNegInf, w[kMaxSplits];
  for (int p = 0; p < splits; ++p)
    mx = fmaxf(mx, ml_part[2 * ((size_t)p * rows + row)]);
  float l = 0.f;
  for (int p = 0; p < splits; ++p) {
    const float2 ml = *reinterpret_cast<const float2*>(
        ml_part + 2 * ((size_t)p * rows + row));
    w[p] = exp2f(ml.x - mx);  // 0 for a split that saw no key of the row
    l += ml.y * w[p];
  }
  const float inv = 1.f / fmaxf(l, kMinDenom);
  if (lse != nullptr && lane == 0)
    lse[row] = (mx + log2f(fmaxf(l, kMinDenom))) * kLn2;
  for (int col = lane; col < D; col += 32) {
    float a = 0.f;
    for (int p = 0; p < splits; ++p)
      a += o_part[((size_t)p * rows + row) * D + col] * w[p];
    o[(size_t)row * D + col] = a * inv;
  }
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// How many CTAs (1-4) share one query block's kv range: the count whose
// grid finishes first on `sms` SMs, CTAs taken in launch order (the
// heaviest query blocks first) by the SM that frees first, a CTA costing
// its kv blocks plus 1.5 for its prologue and epilogue, and a split half
// a block more for the merge kernel (in half-block units below).
int choose_splits(int B, int H, int KH, int S, int T_len, int causal,
                  int window, int sms) {
  const int GP = gcd(H / KH, BM), RP = BM / GP;
  const int nqb = (S + RP - 1) / RP;
  std::vector<int> chain(nqb);  // in launch order
  for (int i = 0; i < nqb; ++i)
    chain[i] = kv_blocks((nqb - 1 - i) * RP, RP, S, T_len, causal, window)
                   .count;
  int best = 1, best_cost = 0;
  for (int splits = 1; splits <= kMaxSplits; ++splits) {
    std::priority_queue<int, std::vector<int>, std::greater<int>> free_at;
    for (int m = 0; m < sms; ++m) free_at.push(0);
    int end = 0;
    for (int g = 0; g < B * (H / GP); ++g)
      for (int c : chain) {
        const int per = (c + splits - 1) / splits;
        for (int part = 0; part < splits; ++part) {
          const int n = std::max(0, std::min(per, c - part * per));
          const int t = free_at.top() + 2 * n + 3;
          free_at.pop();
          free_at.push(t);
          end = std::max(end, t);
        }
      }
    const int cost = end + (splits > 1 ? 1 : 0);
    if (splits == 1 || cost < best_cost) {
      best = splits;
      best_cost = cost;
    }
  }
  return best;
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* o,
           float* o_part, float* ml_part, float* lse, int B, int H, int KH,
           int S, int T_len, int D, int causal, int window, int splits,
           int vec, cudaStream_t stream) {
  // the shared-memory limit is raised once per device
  static int raised[64] = {};
  const int smem = Layout<DP>::total * (int)sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(flash_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = 1;
  }
  const int GP = gcd(H / KH, BM);
  const dim3 grid((S + BM / GP - 1) / (BM / GP) * splits, H / GP, B);
  flash_kernel<DP><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, o_part, ml_part, lse, H, KH, S, T_len, D, GP, causal,
      window, rsqrtf((float)D) * 1.4426950408889634f, splits, vec);
  err = cudaGetLastError();
  if (splits == 1 || err != cudaSuccess) return (int)err;
  const int rows = B * H * S;
  flash_combine_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      o_part, ml_part, o, lse, rows, D, splits);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/flash_attention.py.
// float32 tensors, contiguous; D <= 256. With splits > 1 (what
// flash_attention_splits returns), o_part (splits, B, H, S, D) and ml_part
// (splits, B, H, S, 2) are float32 scratch and a merge kernel follows.
// lse, where non-null, is float32 (B, H, S): each row's log-sum-exp.
// Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* o_part, void* ml_part,
                               void* lse, int B, int H, int KH, int S, int T,
                               int D, int causal, int window, int splits,
                               void* stream) {
  using namespace repro_torch;
  if (D <= 0 || D > kMaxD || H % KH != 0 || T < S || S <= 0 || splits < 1 ||
      splits > kMaxSplits ||
      (splits > 1 && (o_part == nullptr || ml_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(ml_part);
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies and stores need D % 4 == 0 and 16-byte aligned tensors
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(o);
  const int vec = D % 4 == 0 && any % 16 == 0;
  if (D <= 32)
    return launch<32>(qf, kf, vf, of, op, mp, lp, B, H, KH, S, T, D,
                      causal, window, splits, vec, s);
  if (D <= 64)
    return launch<64>(qf, kf, vf, of, op, mp, lp, B, H, KH, S, T, D,
                      causal, window, splits, vec, s);
  if (D <= 128)
    return launch<128>(qf, kf, vf, of, op, mp, lp, B, H, KH, S, T, D,
                       causal, window, splits, vec, s);
  return launch<256>(qf, kf, vf, of, op, mp, lp, B, H, KH, S, T, D,
                     causal, window, splits, vec, s);
}

// How many CTAs share a query block's kv range on device ``device``.
extern "C" int flash_attention_splits(int B, int H, int KH, int S, int T,
                                      int causal, int window, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 1;
  return repro_torch::choose_splits(B, H, KH, S, T, causal, window, sms);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
