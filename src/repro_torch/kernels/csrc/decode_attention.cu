// Decode attention: one new token per row attends, with grouped-query
// heads, to the slots [start[b], length[b]) of a (B, S, KH, D) KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// ::decode_attention_pallas (body _da_kernel). That kernel walks the whole
// sequence on a grid (B, KH, S/512), in order, carrying an online softmax
// in VMEM scratch, and streams even the blocks outside [start, length).
//
// What bounds it on the H100: bytes. Each (row, kv head) reads its K and V
// ranges once and does 4*G flops per element read (G = 4 query heads at
// gemma3-1b), far below the ~295 flops/byte the card needs to be compute
// bound. At gemma3-1b the batched engine gives only B*KH = 4 (row, kv head)
// pairs, so one CTA per pair would leave 128 of 132 SMs idle.
//
// What the design does about it (flash-decoding):
//  * The range of each row is cut into chunks of `chunk` slots, one CTA
//    per (chunk, kv head, row). A CTA whose chunk lies past the row's range
//    exits at once, so only [start, length) is read: a local layer reads at
//    most its 512-slot window, not the whole cache.
//  * Each CTA writes an unnormalised float32 partial (o, running max m,
//    denominator l); a second kernel combines the partials of a row with
//    the usual rescaling and divides by max(l, 1e-30).
//  * Lengths and starts are per row, device-resident int32 vectors: the
//    engine decodes every slot in one launch, each slot at its own length.
//  * A CTA first stages its chunk of K and V rows in shared memory with
//    16-byte loads issued back to back, so a chunk costs about one memory
//    latency, then computes from shared memory (32 slots x 256 x bf16 =
//    16 KB each for K and V; 32 KB each in float32, which is above the
//    48 KB default, so the launch raises the limit).
//  * Slots outside the range are never loaded, which is what -1e30 masking
//    gives once a row has one valid slot. A row whose range is empty (only
//    an idle engine lane, whose output nobody reads) gets zeros, where the
//    plain version averages V over the whole cache.
// Scores, probabilities and accumulators are float32 throughout.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;     // a lane holds kMaxD/32 elements of a K row
constexpr int kMaxG = 8;       // query heads per kv head

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ length, const int* __restrict__ start,
    float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int H, int KH, int S, int D, int chunk,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KH;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int end = min(length[b], S);
  const int lo = max(start[b], 0) + split * chunk;
  const int hi = min(lo + chunk, end);
  if (lo >= hi) return;  // the combine kernel never reads this split
  const int n = hi - lo;

  T* k_s = reinterpret_cast<T*>(smem_raw);              // [chunk][D]
  T* v_s = k_s + (size_t)chunk * D;                     // [chunk][D]
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)chunk * D);  // [G][D]
  float* p_s = q_s + G * D;  // [G][chunk] scores, then probabilities

  // Stage the chunk's K and V rows in shared memory first: every thread
  // issues its loads back to back, so the chunk costs about one memory
  // latency instead of one per slot. 16-byte loads where rows allow.
  const size_t pos_stride = (size_t)KH * D;
  const T* k_base = k + ((size_t)b * S * KH + kh) * D;
  const T* v_base = v + ((size_t)b * S * KH + kh) * D;
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = D % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (vec) {
    const int rv = D / kVec;  // 16-byte vectors per row
#pragma unroll 8
    for (int e = threadIdx.x; e < n * rv; e += kThreads) {
      const int j = e / rv, c = e % rv;
      const size_t off = (size_t)(lo + j) * pos_stride;
      reinterpret_cast<uint4*>(k_s + (size_t)j * D)[c] =
          reinterpret_cast<const uint4*>(k_base + off)[c];
      reinterpret_cast<uint4*>(v_s + (size_t)j * D)[c] =
          reinterpret_cast<const uint4*>(v_base + off)[c];
    }
  } else {
#pragma unroll 8
    for (int e = threadIdx.x; e < n * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const size_t off = (size_t)(lo + j) * pos_stride + d;
      k_s[(size_t)j * D + d] = k_base[off];
      v_s[(size_t)j * D + d] = v_base[off];
    }
  }
  const T* q_row = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads)
    q_s[i] = to_float(q_row[i]) * scale;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // scores: one warp per slot, a lane per 1/32 of the head dimension
  for (int j = warp; j < n; j += kWarps) {
    const T* k_row = k_s + (size_t)j * D;
    float kv[kMaxD / 32];
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < D ? to_float(k_row[d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxD / 32; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc += q_s[g * D + d] * kv[i];
        }
        acc = warp_sum(acc);
        if (lane == 0) p_s[g * chunk + j] = acc;
      }
    }
  }
  __syncthreads();

  // softmax statistics of this chunk, one warp per query head
  const size_t part = ((size_t)(b * KH + kh) * n_split + split) * G;
  for (int g = warp; g < G; g += kWarps) {
    float m = kNegInf;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, p_s[g * chunk + j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(p_s[g * chunk + j] - m);
      p_s[g * chunk + j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_part[part + g] = m;
      l_part[part + g] = l;
    }
  }
  __syncthreads();

  // P V: a thread per element of the head dimension, all G heads at once
  constexpr int kPerThread = kMaxD / kThreads;
  float acc[kMaxG][kPerThread];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) acc[g][c] = 0.f;
  for (int j = 0; j < n; ++j) {
    const T* v_row = v_s + (size_t)j * D;
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      const int d = threadIdx.x + kThreads * c;
      const float vv = d < D ? to_float(v_row[d]) : 0.f;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g][c] += p_s[g * chunk + j] * vv;
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
#pragma unroll
      for (int c = 0; c < kPerThread; ++c) {
        const int d = threadIdx.x + kThreads * c;
        if (d < D) o_part[(part + g) * D + d] = acc[g][c];
      }
    }
  }
}

// One CTA per (query head, row): rescale and sum the row's partials.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, const int* __restrict__ length,
    const int* __restrict__ start, T* __restrict__ out, int H, int KH, int S,
    int D, int chunk, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / KH, kh = h / G, g = h % G;
  const int end = min(length[b], S), begin = max(start[b], 0);
  const int n_valid =
      end > begin ? min((end - begin + chunk - 1) / chunk, n_split) : 0;
  const size_t base = (size_t)(b * KH + kh) * n_split;

  float m_max = kNegInf;
  for (int s = 0; s < n_valid; ++s)
    m_max = fmaxf(m_max, m_part[(base + s) * G + g]);
  float denom = 0.f;
  for (int s = 0; s < n_valid; ++s)
    denom += l_part[(base + s) * G + g] *
             expf(m_part[(base + s) * G + g] - m_max);
  const float inv = 1.f / fmaxf(denom, kMinDenom);

  T* o_row = out + ((size_t)b * H + h) * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < n_valid; ++s)
      acc += o_part[((base + s) * G + g) * D + d] *
             expf(m_part[(base + s) * G + g] - m_max);
    store_as(o_row + d, acc * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* length,
           const int* start, float* o_part, float* m_part, float* l_part,
           void* out, int B, int H, int KH, int S, int D, int chunk,
           int n_split, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem =
      2 * (size_t)chunk * D * sizeof(T) + (size_t)G * (D + chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_split_kernel<T><<<dim3(n_split, KH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, start, o_part, m_part, l_part, H, KH,
      S, D, chunk, rsqrtf((float)D));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<dim3(H, B), kThreads, 0, stream>>>(
      o_part, m_part, l_part, length, start, static_cast<T*>(out), H, KH, S,
      D, chunk, n_split);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/decode_attention.py.
// Scratch: o_part (B, KH, n_split, G, D), m_part and l_part (B, KH, n_split,
// G), float32. Returns a cudaError_t code (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* length, const int* start,
                                float* o_part, float* m_part, float* l_part,
                                void* out, int B, int H, int KH, int S, int D,
                                int chunk, int n_split, int dtype,
                                void* stream) {
  using namespace repro_torch;
  if (D > kMaxD || H % KH != 0 || H / KH > kMaxG || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, length, start, o_part, m_part, l_part, out,
                         B, H, KH, S, D, chunk, n_split, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, length, start, o_part, m_part,
                                 l_part, out, B, H, KH, S, D, chunk, n_split,
                                 s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
