// Flash attention (prefill) in float32: causal and/or sliding-window
// grouped-query attention, q (B, H, S, D) against k, v (B, KH, T, D), query
// positions right-aligned at offset T - S, forward only. bf16 goes to the
// tensor-core kernel of flash_attention_sm90.cu; wgmma takes no float32
// operands, and TF32 would miss the float32 bar of 2e-5.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// ::flash_attention_pallas (body _fa_kernel). That kernel runs a grid
// (B, H, S/128, T/128) with the kv-block axis innermost and in order, so
// its VMEM scratch carries the online softmax from one kv block to the
// next; it visits every kv block, masked or not, and asserts that S and T
// are multiples of the block.
//
// What bounds it on the H100: operations. At a 1024-token gemma3-1b prompt
// (D = 256, G = 4) each K/V element read feeds hundreds of flops, above the
// card's ~295 flops/byte balance point, so the ceiling is the float32
// arithmetic rate of the CUDA cores (67 TFLOP/s).
//
// What the design does:
//  * One CTA per (q block of BQ = 32 rows, head, batch row); the kv-block
//    loop lives inside the CTA and carries the online softmax (running max,
//    denominator, float32 accumulators) in registers, since CTAs have no
//    order and share nothing.
//  * Only the kv blocks that the causal mask and the window leave partly
//    open are visited: [q_first - window + 1, q_last] rounded out to blocks.
//    A 512-token window at a 1024-token prompt visits ~9 of 16 blocks.
//  * Ragged edges (S or T not a multiple of a block) are masked inside the
//    kernel: rows past S are not written, keys past T are masked -1e30.
//  * Shared memory: the Q tile and the K and V tiles (BK = 64) are held in
//    float32 with rows padded to D + 1 words, so that threads reading one
//    column of consecutive rows hit distinct banks, plus the (BQ, BK + 1)
//    score tile. At D = 256 that is (32 + 2*64) * 257 * 4 + 32 * 65 * 4 =
//    172,800 bytes: above the 48 KB default, below the 227 KB a block may
//    have, so the launch raises the limit with cudaFuncSetAttribute. A
//    64-row Q tile would need 215 KB and halve the CTAs of a 1024-token
//    prompt (64 for 132 SMs); 32 rows give 128 CTAs at 4 heads.
//  * 256 threads: for the scores each thread owns a 2 x 4 micro-tile of
//    the 32 x 64 score tile; for P V each warp owns 4 rows and each lane 8
//    columns of the head dimension.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 32;
constexpr int BK = 64;
constexpr int kThreads = 256;
constexpr int kMaxD = 256;
constexpr int kRowsPerWarp = BQ / (kThreads / 32);  // 4
constexpr int kColsPerLane = kMaxD / 32;            // 8

size_t smem_bytes(int D) {
  return ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * (BK + 1)) *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int H, int KH, int S, int T_len, int D, int causal,
    int window, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;             // [BQ][ld], pre-scaled
  float* k_s = q_s + BQ * ld;    // [BK][ld]
  float* v_s = k_s + BK * ld;    // [BK][ld]
  float* p_s = v_s + BK * ld;    // [BQ][BK + 1]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int offset = T_len - S;  // right-aligned query positions
  const T* q_g = q + ((size_t)b * H + h) * S * D;
  const T* k_g = k + ((size_t)b * KH + kh) * T_len * D;
  const T* v_g = v + ((size_t)b * KH + kh) * T_len * D;
  T* o_g = o + ((size_t)b * H + h) * S * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int i = e / D, d = e % D;
    q_s[i * ld + d] =
        q0 + i < S ? to_float(q_g[(size_t)(q0 + i) * D + d]) * scale : 0.f;
  }

  // the kv range any row of this block can see
  const int q_first = q0 + offset;
  const int q_last = min(q0 + BQ, S) - 1 + offset;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp];
  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = 0.f;
  }
  const int ty = tid / 16, tx = tid % 16;  // score micro-tile coordinates

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and Q is loaded)
    for (int e = tid; e < BK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < T_len;
      k_s[j * ld + d] = in ? to_float(k_g[(size_t)(k0 + j) * D + d]) : 0.f;
      v_s[j * ld + d] = in ? to_float(v_g[(size_t)(k0 + j) * D + d]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T: rows ty, ty + 16; columns tx + 16 c
    float s[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float a0 = q_s[ty * ld + d], a1 = q_s[(ty + 16) * ld + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float kk = k_s[(tx + 16 * c) * ld + d];
        s[0][c] += a0 * kk;
        s[1][c] += a1 * kk;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = ty + 16 * r;
      const int qpos = q0 + i + offset;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const int kpos = k0 + j;
        const bool ok = kpos < T_len && (!causal || qpos >= kpos) &&
                        (window <= 0 || qpos - kpos < window);
        p_s[i * (BK + 1) + j] = ok ? s[r][c] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax over this tile, one warp per 4 rows
    float corr[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float* row = p_s + (warp * kRowsPerWarp + r) * (BK + 1);
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_new = fmaxf(m_i[r], warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      corr[r] = expf(m_i[r] - m_new);
      l_i[r] = l_i[r] * corr[r] + warp_sum(p0 + p1);
      m_i[r] = m_new;
      row[lane] = p0;
      row[lane + 32] = p1;
    }
    __syncwarp();

    // O = O * corr + P V
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[r][c] *= corr[r];
    for (int j = 0; j < BK; ++j) {
      float pv[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        pv[r] = p_s[(warp * kRowsPerWarp + r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          const float vv = v_s[j * ld + d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] += pv[r] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = q0 + warp * kRowsPerWarp + r;
    if (i < S) {
      const float inv = 1.f / fmaxf(l_i[r], kMinDenom);
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int d = lane + 32 * c;
        if (d < D) store_as(o_g + (size_t)i * D + d, acc[r][c] * inv);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KH, int S, int T_len, int D, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, S, T_len, D,
      causal, window, rsqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/flash_attention.py.
// Returns a cudaError_t code (0 = launched).
// float32 tensors only.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int KH, int S, int T,
                               int D, int causal, int window, void* stream) {
  using namespace repro_torch;
  if (D > kMaxD || H % KH != 0 || T < S) return (int)cudaErrorInvalidValue;
  return launch<float>(q, k, v, o, B, H, KH, S, T, D, causal, window,
                       static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
