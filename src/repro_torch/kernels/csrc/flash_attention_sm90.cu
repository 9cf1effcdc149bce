// Flash attention (prefill) in bf16 on Hopper's tensor cores: causal and/or
// sliding-window grouped-query attention, q (B, H, S, D) against k, v
// (B, KH, T, D), query positions right-aligned at offset T - S, forward
// only. The float32 path keeps the CUDA-core kernel of flash_attention.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// ::flash_attention_pallas (body _fa_kernel), whose grid (B, H, S/128,
// T/128) walks the kv blocks in order and carries the online softmax in
// VMEM scratch.
//
// What bounds it on the H100: operations. At a 1024-token gemma3-1b prompt
// (D = 256, 4 query heads on 1 kv head) the kernel does ~2 GFLOP on 4 MB,
// far above the card's ~295 flops/byte balance point; the bound is the
// bf16 tensor-core rate. In practice it is the latency of the longest
// chain of kv blocks one CTA walks (each block a dependent run of wgmma,
// the softmax, and another run of wgmma).
//
// What the design does:
//  * Warp specialisation: one consumer warpgroup (128 threads) and one
//    producer warp. The producer's lane 0 loads the Q tile once and keeps
//    K and V tiles of BK = 64 keys in flight by TMA, in a ring of two
//    stages guarded by mbarriers ("full": bytes arrived; "empty": the
//    consumers' wgmma have read the stage).
//  * Tiles are 64 columns of D wide (128 bytes, the TMA box under the
//    128-byte swizzle that wgmma's descriptors read); D is covered by NCB =
//    ceil(D / 64) column blocks, and TMA fills the columns past D, the keys
//    past T and the query rows past S with zeros. Rows past S are not
//    stored. TMA needs a row stride that is a multiple of 16 bytes, so D %
//    8 == 0 (the wrapper refuses other D).
//  * S = Q K^T is wgmma m64n64k16 with both operands in shared memory
//    (K-major). The online softmax runs in registers on the accumulator
//    fragment (row max and sum across the four lanes of a quad); the mask
//    is applied only on kv blocks that straddle the diagonal, the window
//    edge or T. P is rounded to bf16 in registers and is the register A
//    operand of O += P V (wgmma m64n64k16 per 64-column block of D, V read
//    MN-major through the descriptor's transpose bit). O stays in float32
//    registers: NCB x 32 a thread, 128 at D = 256.
//  * GQA: the GP = gcd(G, 64) query heads that share a kv head are packed
//    into the CTA's 64 rows (64 / GP positions each), so each K/V tile
//    crosses device memory once for all of them. At gemma3-1b's G = 4 a
//    1024-token prompt gives 64 CTAs of 16 positions x 4 heads.
//  * Only kv blocks that some row of the CTA can see are visited (the
//    causal bound and the window), and the grid starts with the heaviest
//    (last) query blocks.
//  * Registers: 160 threads a CTA and one CTA an SM (161 KB of shared
//    memory at D = 256), so every thread may hold 255 registers and
//    setmaxnreg has nothing to hand over.
//  * Split kv range: where the CTAs fill at most half the SMs and the
//    longest chain has 8 kv blocks or more, 2-4 CTAs share a query block's
//    kv range and write unnormalised partial rows with their (max, sum); a
//    combine kernel merges them (as decode_attention.cu does). At the 1024
//    bucket that is 128 CTAs with chains of 8 (global) and 5 (window 512)
//    blocks, where one CTA a query block gave 64 CTAs and chains of 16 and
//    9.
//  * The row log-sum-exp (float32 (B, H, S), m + log l in the natural log
//    of the scaled float32 scores), which the backward kernel reads, is
//    written only where its pointer is non-null (training); serving passes
//    null.

#include <cuda.h>  // CUtensorMap and its enums (types only; no libcuda link)
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;           // rows of a CTA: one consumer warpgroup
constexpr int BK = 64;           // keys of a K/V tile
constexpr int kStages = 2;
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kTile = 64 * 64;             // elements of one 64 x 64 tile
constexpr int kMaxCB = 4;                  // D <= 256

template <int NCB>
struct Smem {
  bf16 q[NCB][kTile];
  bf16 k[kStages][NCB][kTile];
  bf16 v[kStages][NCB][kTile];
  uint64_t full[kStages], empty[kStages], qbar;
};

constexpr int kMaxSplits = 4;

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

template <int NCB>
constexpr size_t smem_bytes() {
  return sizeof(Smem<NCB>) + 1024;  // + alignment of the swizzled tiles
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 64 x 64 bf16 tile written by TMA with
// the 128-byte swizzle: 8-row groups 1024 bytes apart. The same 1024 goes in
// both offset fields: whichever of them strides the other dimension, an
// m64n64k16 never leaves its 64-wide swizzle atom in that dimension.
__device__ __forceinline__ uint64_t tile_desc(const bf16* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_D32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define REPRO_D32_LIST                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int NCB>
__global__ void __launch_bounds__(kThreads, 1) flash_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
    float* __restrict__ o_part, float* __restrict__ ml_part,
    float* __restrict__ lse, int H, int KH, int S, int T_len, int D, int GP,
    int causal, int window, float scale_log2, int splits) {
  extern __shared__ uint8_t smem_raw[];
  Smem<NCB>& sm = *reinterpret_cast<Smem<NCB>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int RP = BM / GP;  // query positions a CTA holds per head
  const int nqb = gridDim.x / splits, part = blockIdx.x % splits;
  const int s0 = (nqb - 1 - blockIdx.x / splits) * RP;  // heaviest first
  const int h0 = blockIdx.y * GP, b = blockIdx.z;
  const int kh = h0 / (H / KH);
  const int offset = T_len - S;
  const int q_first = s0 + offset;
  const int q_last = min(s0 + RP, S) - 1 + offset;
  // this CTA's share of the blocks the query block sees
  const KvBlocks all = kv_blocks(s0, RP, S, T_len, causal, window);
  const int per = (all.count + splits - 1) / splits;
  const int kb0 = all.first + part * per;
  const int nblocks = max(0, min(per, all.count - part * per));

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    mbar_init(&sm.qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: TMA loads ----
    if (tid == kConsumers) {
      mbar_expect_tx(&sm.qbar, NCB * kTile * sizeof(bf16));
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        tma_load_3d(sm.q[cb], &qmap, &sm.qbar, cb * 64, s0, b * H + h0);
      for (int i = 0; i < nblocks; ++i) {
        const int st = i % kStages, round = i / kStages;
        mbar_wait(&sm.empty[st], (round & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 2 * NCB * kTile * sizeof(bf16));
        const int k0 = (kb0 + i) * BK;
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          tma_load_3d(sm.k[st][cb], &kmap, &sm.full[st], cb * 64, k0,
                      b * KH + kh);
          tma_load_3d(sm.v[st][cb], &vmap, &sm.full[st], cb * 64, k0,
                      b * KH + kh);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = 16 * warp + lane / 4 + 8 * r;  // row of the CTA's tile
    qpos[r] = s0 + (m & (RP - 1)) + offset;
  }
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  float acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;

  mbar_wait(&sm.qbar, 0);
  for (int i = 0; i < nblocks; ++i) {
    const int st = i % kStages, round = i / kStages;
    const int k0 = (kb0 + i) * BK;
    mbar_wait(&sm.full[st], round & 1);

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      const uint64_t dq = tile_desc(sm.q[cb]), dk = tile_desc(sm.k[st][cb]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 columns = 32 bytes = 2 units
        wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, cb + kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const bool full = k0 + BK <= T_len && (!causal || k0 + BK - 1 <= q_first) &&
                      (window <= 0 || q_last - k0 < window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float x = s[4 * j + e] * scale_log2;
        if (!full) {
          const int kpos = k0 + 8 * j + 2 * quad + (e & 1);
          const bool ok = kpos < T_len && (!causal || qpos[r] >= kpos) &&
                          (window <= 0 || qpos[r] - kpos < window);
          x = ok ? x : kNegInf;
        }
        s[4 * j + e] = x;
      }

    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_i[r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * j + 2 * r + e] - mx);
          s[4 * j + 2 * r + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      corr[r] = exp2f(m_i[r] - mx);
      l_i[r] = l_i[r] * corr[r] + sum;
      m_i[r] = mx;
    }
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[cb][e] *= corr[(e / 2) & 1];

    // P (bf16) as the A fragments of four k16 steps
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[kk][a] = pack_bf16(s[8 * kk + 2 * a], s[8 * kk + 2 * a + 1]);

#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
    wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      const uint64_t dv = tile_desc(sm.v[st][cb]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 keys = 16 rows of 128 bytes
        wgmma_rs(acc[cb], pa[kk], dv + (16 * 128 >> 4) * kk);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
    mbar_arrive(&sm.empty[st]);
  }

  // epilogue: O / l, or with a split kv range the unnormalised O and the
  // row's (max, sum) for the combine; rows past S and columns past D are
  // not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = 16 * warp + lane / 4 + 8 * r;
    const int spos = s0 + (m & (RP - 1));
    if (spos >= S) continue;
    const size_t row = (size_t)(b * H + h0 + m / RP) * S + spos;
    if (splits == 1) {
      const float inv = 1.f / fmaxf(l_i[r], kMinDenom);
      if (lse != nullptr && quad == 0)
        lse[row] = (m_i[r] + log2f(fmaxf(l_i[r], kMinDenom))) * kLn2;
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cb * 64 + 8 * j + 2 * quad;
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(o + row * D + col) =
                __floats2bfloat162_rn(acc[cb][4 * j + 2 * r] * inv,
                                      acc[cb][4 * j + 2 * r + 1] * inv);
        }
    } else {
      const size_t prow = (size_t)part * gridDim.z * H * S + row;
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cb * 64 + 8 * j + 2 * quad;
          if (col < D)
            *reinterpret_cast<float2*>(o_part + prow * D + col) = make_float2(
                acc[cb][4 * j + 2 * r], acc[cb][4 * j + 2 * r + 1]);
        }
      if (quad == 0)
        *reinterpret_cast<float2*>(ml_part + 2 * prow) =
            make_float2(m_i[r], l_i[r]);
    }
  }
}

// Merge the splits' partial rows: one warp a row of O (B * H * S rows),
// and the row's log-sum-exp where lse is non-null.
__global__ void __launch_bounds__(256) flash_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ ml_part,
    bf16* __restrict__ o, float* __restrict__ lse, int rows, int D,
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
  for (int col = 2 * lane; col < D; col += 64) {
    float2 a = make_float2(0.f, 0.f);
    for (int p = 0; p < splits; ++p) {
      const float2 v = *reinterpret_cast<const float2*>(
          o_part + ((size_t)p * rows + row) * D + col);
      a.x += v.x * w[p];
      a.y += v.y * w[p];
    }
    *reinterpret_cast<__nv_bfloat162*>(o + (size_t)row * D + col) =
        __floats2bfloat162_rn(a.x * inv, a.y * inv);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime so that the library
// needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// A (planes, rows, D) bf16 tensor read in boxes of 64 columns x box_rows x
// box_planes, 128-byte swizzle, zeros outside the tensor.
cudaError_t make_map(CUtensorMap* map, EncodeTiled enc, const void* base,
                     int D, int rows, int planes, int box_rows,
                     int box_planes) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(bf16),
                                 (cuuint64_t)D * rows * sizeof(bf16)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows,
                             (cuuint32_t)box_planes};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// How many CTAs share one query block's kv range: enough to fill the SMs
// once, each with at least 4 kv blocks of the longest chain, at most 4.
int choose_splits(int B, int H, int KH, int S, int T_len, int causal,
                  int window, int sms) {
  const int GP = gcd(H / KH, BM), RP = BM / GP;
  const int nqb = (S + RP - 1) / RP;
  int chain = 0;
  for (int qb = 0; qb < nqb; ++qb)
    chain = std::max(chain,
                     kv_blocks(qb * RP, RP, S, T_len, causal, window).count);
  const int ctas = nqb * (H / GP) * B;
  return std::max(1, std::min({kMaxSplits, chain / 4, sms / ctas}));
}

template <int NCB>
int launch(const void* q, const void* k, const void* v, void* o,
           float* o_part, float* ml_part, float* lse, int B, int H, int KH,
           int S, int T_len, int D, int causal, int window, int splits,
           cudaStream_t stream) {
  EncodeTiled enc;
  cudaError_t err = encode_fn(&enc);
  if (err != cudaSuccess) return (int)err;
  const int GP = gcd(H / KH, BM);
  CUtensorMap qmap, kmap, vmap;
  if ((err = make_map(&qmap, enc, q, D, S, B * H, BM / GP, GP)) ||
      (err = make_map(&kmap, enc, k, D, T_len, B * KH, BK, 1)) ||
      (err = make_map(&vmap, enc, v, D, T_len, B * KH, BK, 1)))
    return (int)err;
  const size_t smem = smem_bytes<NCB>();
  err = cudaFuncSetAttribute(flash_sm90_kernel<NCB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BM / GP - 1) / (BM / GP) * splits, H / GP, B);
  flash_sm90_kernel<NCB><<<grid, kThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), o_part, ml_part, lse, H, KH,
      S, T_len, D, GP, causal, window,
      rsqrtf((float)D) * 1.4426950408889634f, splits);
  err = cudaGetLastError();
  if (splits == 1 || err != cudaSuccess) return (int)err;
  const int rows = B * H * S;
  flash_combine_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      o_part, ml_part, static_cast<bf16*>(o), lse, rows, D, splits);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/flash_attention.py. bf16
// tensors, contiguous, 16-byte aligned; D % 8 == 0 and D <= 256. With
// splits > 1 (what flash_attention_sm90_splits returns), o_part (splits, B,
// H, S, D) and ml_part (splits, B, H, S, 2) are float32 scratch and a
// combine kernel follows. lse, where non-null, is float32 (B, H, S): each
// row's log-sum-exp. Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_sm90(const void* q, const void* k,
                                    const void* v, void* o, void* o_part,
                                    void* ml_part, void* lse, int B, int H,
                                    int KH, int S, int T, int D, int causal,
                                    int window, int splits, void* stream) {
  using namespace repro_torch;
  if (D <= 0 || D > 64 * kMaxCB || D % 8 != 0 || H % KH != 0 || T < S ||
      S <= 0 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (o_part == nullptr || ml_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(ml_part);
  float* lp = static_cast<float*>(lse);
  switch ((D + 63) / 64) {
    case 1:
      return launch<1>(q, k, v, o, op, mp, lp, B, H, KH, S, T, D, causal,
                       window, splits, s);
    case 2:
      return launch<2>(q, k, v, o, op, mp, lp, B, H, KH, S, T, D, causal,
                       window, splits, s);
    case 3:
      return launch<3>(q, k, v, o, op, mp, lp, B, H, KH, S, T, D, causal,
                       window, splits, s);
    default:
      return launch<4>(q, k, v, o, op, mp, lp, B, H, KH, S, T, D, causal,
                       window, splits, s);
  }
}

// How many CTAs share a query block's kv range on device ``device``.
extern "C" int flash_attention_sm90_splits(int B, int H, int KH, int S, int T,
                                           int causal, int window,
                                           int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 1;
  return repro_torch::choose_splits(B, H, KH, S, T, causal, window, sms);
}

extern "C" const char* flash_attention_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
