// The backward of flash attention: causal and/or sliding-window
// grouped-query attention, q (B, H, S, D) against k, v (B, KH, T, D), query
// positions right-aligned at offset T - S, as the forward kernels compute
// it. From the forward's output O and row log-sum-exp lse (float32
// (B, H, S)) and the output's gradient dO it gives dQ, dK and dV in the
// inputs' type (float32 or bf16), any D <= 256, accumulating in float32.
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
// each (query, key) pair the masks let through, each input read once and
// each gradient written once: at gemma3-1b's training shape (4 rows of
// 1,024 tokens, 4 query heads on 1 kv head, D = 256) ~21 GFLOP against
// ~40 MB, far above the card's balance point; the bound is 67 TFLOP/s of
// float32 FMA (989 TFLOP/s in bf16 on the tensor cores, which this kernel
// does not use).
//
// What the design does (simple and right first; wgmma and TMA are later
// work):
//  * Three launches: a preprocess of delta (one warp a row); a dK/dV kernel
//    with one CTA a (row, kv head, block of 32 keys), which loops over the
//    G query heads and over only the 32-row query blocks that the causal
//    bound and the window let see its keys, and sums GQA in registers, so
//    it needs no atomics; a dQ kernel with one CTA a (row, head, block of
//    32 queries), which loops over the key blocks in range. The dQ kernel
//    computes S and dP again (seven products issued for the five counted).
//  * d_head 256 in float32 is the tight spot: a 64-row tile of 256 floats
//    is 64 KB, and K, V, dK and dV of a 64-key block would need ~256 KB,
//    past the 227 KB a CTA may have. So both blocks are 32 rows: K, V (or
//    Q, dO) resident, Q, dO (or K, V) streamed, as float tiles of D padded
//    to DP = 32, 64, 128 or 256 (rows DP + 4 floats apart, which keeps the
//    16-byte loads of a quarter warp on distinct banks), P and dS as 32 x 33
//    floats: 141,824 bytes at DP = 256. bf16 is widened to float as it is
//    loaded, so one layout serves both types. dK and dV (or dQ) stay in
//    registers: 32 rows x DP / 256 threads, 64 floats a thread at DP = 256.
//  * Products on the CUDA cores in float32: S and dP as 2 x 2 register
//    blocks a thread (four 16-byte shared loads for 16 FMAs), dV, dK and dQ
//    as rows x 4 columns a thread with the P or dS entry broadcast.
//  * At gemma3-1b's shape the dK/dV grid is 32 key blocks x 4 rows = 128
//    CTAs, about one wave of 132 SMs; the causal mask makes the first key
//    blocks the heaviest (32 query blocks x 4 heads).

#include <cmath>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 32;   // query rows of a tile
constexpr int BKV = 32;  // keys of a tile
constexpr int kThreads = 256;
constexpr int kMaxD = 256;

// Shared-memory layout (floats) for D padded to DP: four 32-row tiles, P
// and dS, and the query rows' lse and delta.
template <int DP>
struct Layout {
  static constexpr int ld = DP + 4;     // 4 mod 32
  static constexpr int ldp = BKV + 1;
  static constexpr int tile = 32 * ld;
  static constexpr int p = 4 * tile;
  static constexpr int ds = p + BQ * ldp;
  static constexpr int lse = ds + BQ * ldp;
  static constexpr int delta = lse + BQ;
  static constexpr int total = delta + BQ;
};

__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows [r0, r0 + 32) of a row-major (n_rows, D) matrix of T as a 32 x DP
// float tile, zeros past n_rows and past D.
template <int DP, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n_rows, int D) {
  constexpr int ld = DP + 4;
  for (int e = threadIdx.x; e < 32 * DP; e += kThreads) {
    const int r = e / DP, c = e % DP, row = r0 + r;
    dst[r * ld + c] =
        row < n_rows && c < D ? to_float(src[(size_t)row * D + c]) : 0.f;
  }
}

// The 32 x 32 product A B^T of two 32 x DP tiles: thread (a, b) =
// (tid / 16, tid % 16) gives rows a, a + 16 and columns b, b + 16.
template <int DP>
__device__ __forceinline__ void dot_tiles(const float* A, const float* Bt,
                                          float (&acc)[2][2]) {
  constexpr int ld = DP + 4;
  const int a = threadIdx.x / 16, b = threadIdx.x % 16;
  const float* a0 = A + a * ld;
  const float* a1 = A + (a + 16) * ld;
  const float* b0 = Bt + b * ld;
  const float* b1 = Bt + (b + 16) * ld;
  float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + c);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + c);
    const float4 y0 = *reinterpret_cast<const float4*>(b0 + c);
    const float4 y1 = *reinterpret_cast<const float4*>(b1 + c);
    s00 = fmaf(x0.x, y0.x, s00);
    s01 = fmaf(x0.x, y1.x, s01);
    s10 = fmaf(x1.x, y0.x, s10);
    s11 = fmaf(x1.x, y1.x, s11);
    s00 = fmaf(x0.y, y0.y, s00);
    s01 = fmaf(x0.y, y1.y, s01);
    s10 = fmaf(x1.y, y0.y, s10);
    s11 = fmaf(x1.y, y1.y, s11);
    s00 = fmaf(x0.z, y0.z, s00);
    s01 = fmaf(x0.z, y1.z, s01);
    s10 = fmaf(x1.z, y0.z, s10);
    s11 = fmaf(x1.z, y1.z, s11);
    s00 = fmaf(x0.w, y0.w, s00);
    s01 = fmaf(x0.w, y1.w, s01);
    s10 = fmaf(x1.w, y0.w, s10);
    s11 = fmaf(x1.w, y1.w, s11);
  }
  acc[0][0] = s00;
  acc[0][1] = s01;
  acc[1][0] = s10;
  acc[1][1] = s11;
}

// P and dS of the tile pair (queries s0.., keys k0..) from S and dP: the
// thread's four entries, masked (0 where a query may not see the key, or
// past S or T), rounded to T; P is stored only where p_s is non-null.
template <typename T>
__device__ __forceinline__ void probs(const float (&sc)[2][2],
                                      const float (&dp)[2][2], float* p_s,
                                      float* ds_s, const float* lse_s,
                                      const float* delta_s, int s0, int k0,
                                      int S, int T_len, int causal,
                                      int window, float scale) {
  constexpr int ldp = BKV + 1;
  const int a = threadIdx.x / 16, b = threadIdx.x % 16, offset = T_len - S;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int i = a + 16 * ii, j = b + 16 * jj;
      const int s = s0 + i, kpos = k0 + j, qpos = s + offset;
      const bool ok = s < S && kpos < T_len && (!causal || qpos >= kpos) &&
                      (window <= 0 || qpos - kpos < window);
      const float p = ok ? expf(sc[ii][jj] * scale - lse_s[i]) : 0.f;
      if (p_s != nullptr) p_s[i * ldp + j] = round_as(p, T());
      ds_s[i * ldp + j] = round_as(p * (dp[ii][jj] - delta_s[i]) * scale, T());
    }
}

// Rows [s0, s0 + 32) of a head's lse and delta into shared memory.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, size_t head,
                                          int s0, int S) {
  if (threadIdx.x < BQ) {
    const int s = s0 + threadIdx.x;
    lse_s[threadIdx.x] = s < S ? lse[head + s] : 0.f;
    delta_s[threadIdx.x] = s < S ? delta[head + s] : 0.f;
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

// dK and dV of one block of 32 keys of one (row, kv head), summed over the
// kv head's G query heads and the query blocks that see the block.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int KH, int S, int T_len,
    int D, int causal, int window, float scale) {
  using L = Layout<DP>;
  constexpr int NCG = DP / 4;          // 4-column groups of a row
  constexpr int RPT = BKV * NCG / kThreads;  // key rows a thread sums
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = smem + L::tile;
  float* q_s = smem + 2 * L::tile;
  float* do_s = smem + 3 * L::tile;
  float* p_s = smem + L::p;
  float* ds_s = smem + L::ds;
  float* lse_s = smem + L::lse;
  float* delta_s = smem + L::delta;

  const int k0 = blockIdx.x * BKV, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH, offset = T_len - S;
  const size_t kv_head = (size_t)(b * KH + kh) * T_len;
  load_tile<DP>(k_s, k + kv_head * D, k0, T_len, D);
  load_tile<DP>(v_s, v + kv_head * D, k0, T_len, D);

  // the query rows [s_begin, s_end) that see some key of the block
  const int k_last = min(k0 + BKV, T_len) - 1;
  const int s_begin = causal ? max(0, k0 - offset) : 0;
  const int s_end = window > 0 ? min(S, k_last + window - offset) : S;
  const int qb_first = s_begin / BQ;
  const int qb_end = s_end > s_begin ? (s_end + BQ - 1) / BQ : qb_first;

  const int cg = threadIdx.x % NCG, r0 = (threadIdx.x / NCG) * RPT;
  float dk_acc[RPT][4], dv_acc[RPT][4];
#pragma unroll
  for (int u = 0; u < RPT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[u][e] = dv_acc[u][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const size_t head = (size_t)(b * H + kh * G + g) * S;
    for (int qb = qb_first; qb < qb_end; ++qb) {
      const int s0 = qb * BQ;
      __syncthreads();  // the previous query block's tiles are consumed
      load_tile<DP>(q_s, q + head * D, s0, S, D);
      load_tile<DP>(do_s, dout + head * D, s0, S, D);
      load_rows(lse_s, delta_s, lse, delta, head, s0, S);
      __syncthreads();
      float sc[2][2], dp[2][2];
      dot_tiles<DP>(q_s, k_s, sc);
      dot_tiles<DP>(do_s, v_s, dp);
      probs<T>(sc, dp, p_s, ds_s, lse_s, delta_s, s0, k0, S, T_len,
                   causal, window, scale);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q on key rows r0 .. r0 + RPT - 1,
      // columns 4 cg .. 4 cg + 3
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float4 dov =
            *reinterpret_cast<const float4*>(do_s + i * L::ld + 4 * cg);
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + i * L::ld + 4 * cg);
#pragma unroll
        for (int u = 0; u < RPT; ++u) {
          const float p = p_s[i * L::ldp + r0 + u];
          const float ds = ds_s[i * L::ldp + r0 + u];
          dv_acc[u][0] = fmaf(p, dov.x, dv_acc[u][0]);
          dv_acc[u][1] = fmaf(p, dov.y, dv_acc[u][1]);
          dv_acc[u][2] = fmaf(p, dov.z, dv_acc[u][2]);
          dv_acc[u][3] = fmaf(p, dov.w, dv_acc[u][3]);
          dk_acc[u][0] = fmaf(ds, qv.x, dk_acc[u][0]);
          dk_acc[u][1] = fmaf(ds, qv.y, dk_acc[u][1]);
          dk_acc[u][2] = fmaf(ds, qv.z, dk_acc[u][2]);
          dk_acc[u][3] = fmaf(ds, qv.w, dk_acc[u][3]);
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int kpos = k0 + r0 + u;
    if (kpos >= T_len) continue;
    const size_t row = (kv_head + kpos) * D;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * cg + e;
      if (c < D) {
        store_as(dk + row + c, dk_acc[u][e]);
        store_as(dv + row + c, dv_acc[u][e]);
      }
    }
  }
}

// dQ of one block of 32 queries of one (row, head), over the key blocks it
// sees.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int KH, int S, int T_len, int D, int causal,
    int window, float scale) {
  using L = Layout<DP>;
  constexpr int NCG = DP / 4;
  constexpr int RPT = BQ * NCG / kThreads;  // query rows a thread sums
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = smem + L::tile;
  float* k_s = smem + 2 * L::tile;
  float* v_s = smem + 3 * L::tile;
  float* ds_s = smem + L::ds;
  float* lse_s = smem + L::lse;
  float* delta_s = smem + L::delta;

  const int s0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH), offset = T_len - S;
  const size_t head = (size_t)(b * H + h) * S;
  const size_t kv_head = (size_t)(b * KH + kh) * T_len;
  load_tile<DP>(q_s, q + head * D, s0, S, D);
  load_tile<DP>(do_s, dout + head * D, s0, S, D);
  load_rows(lse_s, delta_s, lse, delta, head, s0, S);

  // the key blocks that some query of the block sees: the causal bound
  // and the window
  const int q_first = s0 + offset;
  const int q_last = min(s0 + BQ, S) - 1 + offset;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;
  const int kb_first = k_begin / BKV;
  const int kb_end = k_end > k_begin ? (k_end + BKV - 1) / BKV : kb_first;

  const int cg = threadIdx.x % NCG, r0 = (threadIdx.x / NCG) * RPT;
  float dq_acc[RPT][4];
#pragma unroll
  for (int u = 0; u < RPT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[u][e] = 0.f;

  for (int kb = kb_first; kb < kb_end; ++kb) {
    const int k0 = kb * BKV;
    __syncthreads();  // the previous key block's tiles are consumed
    load_tile<DP>(k_s, k + kv_head * D, k0, T_len, D);
    load_tile<DP>(v_s, v + kv_head * D, k0, T_len, D);
    __syncthreads();
    float sc[2][2], dp[2][2];
    dot_tiles<DP>(q_s, k_s, sc);
    dot_tiles<DP>(do_s, v_s, dp);
    probs<T>(sc, dp, nullptr, ds_s, lse_s, delta_s, s0, k0, S, T_len,
                 causal, window, scale);
    __syncthreads();
    // dQ += dS K on query rows r0 .. r0 + RPT - 1, columns 4 cg .. + 3
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float4 kv =
          *reinterpret_cast<const float4*>(k_s + j * L::ld + 4 * cg);
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        const float ds = ds_s[(r0 + u) * L::ldp + j];
        dq_acc[u][0] = fmaf(ds, kv.x, dq_acc[u][0]);
        dq_acc[u][1] = fmaf(ds, kv.y, dq_acc[u][1]);
        dq_acc[u][2] = fmaf(ds, kv.z, dq_acc[u][2]);
        dq_acc[u][3] = fmaf(ds, kv.w, dq_acc[u][3]);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int s = s0 + r0 + u;
    if (s >= S) continue;
    const size_t row = (head + s) * D;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * cg + e;
      if (c < D) store_as(dq + row + c, dq_acc[u][e]);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KH, int S, int T_len, int D,
           int causal, int window, cudaStream_t stream) {
  const int smem = Layout<DP>::total * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float scale = (float)(1.0 / std::sqrt((double)D));
  const int rows = B * H * S;
  delta_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, rows, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dkdv_kernel<T, DP><<<dim3((T_len + BKV - 1) / BKV, KH, B), kThreads, smem,
                       stream>>>(qt, kt, vt, dot, lse, delta,
                                 static_cast<T*>(dk), static_cast<T*>(dv), H,
                                 KH, S, T_len, D, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dq_kernel<T, DP><<<dim3((S + BQ - 1) / BQ, H, B), kThreads, smem,
                     stream>>>(qt, kt, vt, dot, lse, delta,
                               static_cast<T*>(dq), H, KH, S, T_len, D,
                               causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, float* delta, void* dq,
             void* dk, void* dv, int B, int H, int KH, int S, int T_len,
             int D, int causal, int window, cudaStream_t s) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KH,
                         S, T_len, D, causal, window, s);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KH,
                         S, T_len, D, causal, window, s);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H,
                          KH, S, T_len, D, causal, window, s);
  return launch<T, 256>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KH,
                        S, T_len, D, causal, window, s);
}

}  // namespace
}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/flash_attention.py.
// q, o, dout, dq (B, H, S, D) and k, v, dk, dv (B, KH, T, D) of one type
// (dtype: 0 float32, 1 bf16), contiguous; lse (B, H, S) float32 from the
// forward; delta (B, H, S) float32 scratch. Three kernels on `stream`.
// Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int H, int KH, int S, int T, int D,
    int causal, int window, void* stream) {
  using namespace repro_torch;
  if (D <= 0 || D > kMaxD || KH <= 0 || H % KH != 0 || T < S || S <= 0 ||
      B <= 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_d<float>(q, k, v, o, l, dout, d, dq, dk, dv, B, H, KH, S,
                           T, D, causal, window, s);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(q, k, v, o, l, dout, d, dq, dk, dv, B, H,
                                   KH, S, T, D, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
