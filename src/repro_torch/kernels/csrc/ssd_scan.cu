// Mamba-2 chunked SSD scan (state-space duality, arXiv:2405.21060), forward,
// with dt folded in: for each (batch row, head) over chunks of ck positions,
//   y      = ((C B^T) o L) (x dt)  +  exp(cs) * (C S_prev^T)
//   S_next = S_prev * exp(cs_last) + ((x dt) * exp(cs_last - cs))^T B
// where cs is the within-chunk cumulative sum of dt * A and
// L[i][j] = exp(cs_i - cs_j) for i >= j, else 0.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_pallas (body
// _ssd_kernel). That kernel runs a grid (b, h, chunks) whose chunk axis is
// sequential on the TPU core, so a (P, N) float32 VMEM scratch carries the
// state from one chunk to the next, and writes each chunk's four products as
// MXU matmuls.
//
// What bounds it on the H100: bytes, by the data sheet. At the mamba2-370m
// prefill shape (h 32, p 64, n 128, chunk 128) a 1024-token prompt reads
// and writes ~9 MB in bf16 (x, y, B, C, dt, the final state) for ~1.4
// GFLOP, 2.7 us over 3.35 TB/s against 1.4 us of bf16 tensor-core math.
// This first version computes on the CUDA cores in float32 (no tensor
// cores yet), so in practice it is bound by those cores and by shared
// memory reads, far above that bound; wgmma and TMA are later work.
//
// What the design does:
//  * Blocks run in no order, so the chunk loop lives inside the CTA: one
//    CTA per (tile of PT = 16 state rows, head, batch row) walks the chunks
//    left to right and keeps its (PT, N) slice of the float32 state in
//    shared memory for the whole scan. State rows (the P axis) never mix,
//    so the tiles need no synchronisation with each other. At b = 1, h =
//    32, p = 64 that is 128 CTAs for 132 SMs (one CTA per (b, h) would
//    give 32). Each tile recomputes the chunk's (C B^T) o L, the price of
//    that parallelism.
//  * Per chunk: stage dt, x (as x * dt), B and C in float32; warp 0 scans
//    dt * A and forms exp(cs) and exp(cs_last - cs). exp is only ever taken
//    of cs_i - cs_j with i >= j (never of the upper triangle, where it
//    could overflow). The scan adds in float32 but rounds each partial sum
//    to the input type where the reference's bf16 cumsum rounds (in runs of
//    16 rows, then across runs; kernels/ref.py::_cumsum): over a 128-row
//    chunk the sum reaches ~-100, where a bf16 step is 0.5, so a scan that
//    rounded elsewhere would move exp(cs_i - cs_j) by tens of percent
//    against the reference. In float32 the rounding is a no-op.
//  * The products run on the CUDA cores with float32 accumulation. For
//    (C B^T) o L each thread owns an 8 x 8 register micro-tile of rows
//    ty + 16a and columns tx + 16b; pairs with a < b lie wholly above the
//    diagonal and are skipped. Where the TPU kernel rounds (C B^T) o L to
//    the input dtype before its product with x dt, this kernel keeps
//    float32.
//  * Shared memory, float32, rows padded by one word so that threads
//    reading one column of consecutive rows hit distinct banks: B, C
//    (ck x (N + 1) each), (C B^T) o L (ck x (ck + 1)), x dt (ck x PT), the
//    state (PT x (N + 1)) and three ck vectors. At ck = 128, N = 128 that
//    is 216,128 bytes: above the 48 KB default, so the launch raises the
//    limit; the wrapper refuses shapes past the card's maximum.
//  * Ragged chunks (ck not a multiple of 16) are zero-padded in shared
//    memory; ragged P is masked. ck <= 128 and N <= 128 (the register
//    micro-tiles).

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int PT = 16;        // state rows (P) per CTA
constexpr int kMaxCk = 128;   // chunk rows: 8 micro-tile rows of 16
constexpr int kMaxA = kMaxCk / 16;
constexpr int kMaxN = 128;    // state width: 8 columns of 16 a thread
constexpr int kRun = 16;      // rows a cumulative sum runs before it carries

// x rounded to T's precision (a no-op for float)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

struct Layout {
  int ckp, ldn, ldg;          // padded chunk rows, row strides
  size_t b, c, g, xd, s, cs, ecs, dec, total;  // offsets in floats
};

__host__ __device__ inline Layout make_layout(int ck, int N) {
  Layout L;
  L.ckp = (ck + 15) / 16 * 16;
  L.ldn = N + 1;
  L.ldg = L.ckp + 1;
  L.b = 0;
  L.c = L.b + (size_t)L.ckp * L.ldn;
  L.g = L.c + (size_t)L.ckp * L.ldn;
  L.xd = L.g + (size_t)L.ckp * L.ldg;
  L.s = L.xd + (size_t)L.ckp * PT;
  L.cs = L.s + (size_t)PT * L.ldn;
  L.ecs = L.cs + L.ckp;
  L.dec = L.ecs + L.ckp;
  L.total = L.dec + L.ckp;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    const T* __restrict__ init, T* __restrict__ y, T* __restrict__ fin,
    int l, int H, int P, int N, int ck) {
  extern __shared__ float smem[];
  const Layout lay = make_layout(ck, N);
  float* B_s = smem + lay.b;
  float* C_s = smem + lay.c;
  float* G_s = smem + lay.g;
  float* xd_s = smem + lay.xd;
  float* S_s = smem + lay.s;
  float* cs_s = smem + lay.cs;
  float* ecs_s = smem + lay.ecs;
  float* dec_s = smem + lay.dec;
  const int ldn = lay.ldn, ldg = lay.ldg, ckp = lay.ckp;
  const int nA = ckp / 16;

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const float a_h = to_float(A[h]);

  // the state entering the first chunk
  for (int e = tid; e < PT * N; e += kThreads) {
    const int r = e / N, n = e % N;
    float v = 0.f;
    if (init != nullptr && p0 + r < P)
      v = to_float(init[(((size_t)b * H + h) * P + p0 + r) * N + n]);
    S_s[r * ldn + n] = v;
  }

  const int nc = l / ck;
  for (int c = 0; c < nc; ++c) {
    const size_t t0 = (size_t)b * l + (size_t)c * ck;  // first row of chunk
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < ckp * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const bool in = i < ck;
      B_s[i * ldn + n] = in ? to_float(Bm[(t0 + i) * N + n]) : 0.f;
      C_s[i * ldn + n] = in ? to_float(Cm[(t0 + i) * N + n]) : 0.f;
    }
    for (int e = tid; e < ckp * PT; e += kThreads) {
      const int i = e / PT, r = e % PT;
      float v = 0.f;
      if (i < ck && p0 + r < P) {
        const float d = to_float(dt[(t0 + i) * H + h]);
        v = to_float(x[((t0 + i) * H + h) * P + p0 + r]) * d;
      }
      xd_s[i * PT + r] = v;
    }
    if (tid < 32) {
      // inclusive scan of dt * A over the chunk, rounded where the
      // reference rounds (ref.py::_cumsum): lane q sums run q of 16 rows
      // in order, each partial sum rounded to T; a lane's offset is the
      // rounded running sum of the earlier runs' totals
      const int lane = tid, runs = (ck + kRun - 1) / kRun;
      float within[kRun];
      float tot = 0.f;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const int i = lane * kRun + k;
        if (lane < runs && i < ck) {
          const float v =
              round_to<T>(to_float(dt[(t0 + i) * H + h]) * a_h);
          tot = k == 0 ? v : round_to<T>(tot + v);
        }
        within[k] = tot;
      }
      float off = 0.f;
      for (int q = 0; q < runs; ++q) {
        const float t = __shfl_sync(0xffffffffu, tot, q);
        if (q < lane) off = q == 0 ? t : round_to<T>(off + t);
      }
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const int i = lane * kRun + k;
        if (lane < runs && i < ck)
          cs_s[i] = lane == 0 ? within[k] : round_to<T>(within[k] + off);
      }
      __syncwarp();
      const float last = cs_s[ck - 1];
      for (int i = lane; i < ckp; i += 32) {
        const bool in = i < ck;
        const float ci = in ? cs_s[i] : 0.f;
        if (!in) cs_s[i] = 0.f;
        ecs_s[i] = in ? expf(ci) : 0.f;
        dec_s[i] = in ? expf(last - ci) : 0.f;   // last <= ci: cs falls
      }
    }
    __syncthreads();

    // (C B^T) o L, lower triangle; rows ty + 16a, columns tx + 16b
    {
      const int ty = tid / 16, tx = tid % 16;
      float acc[kMaxA][kMaxA];
#pragma unroll
      for (int a = 0; a < kMaxA; ++a)
#pragma unroll
        for (int bb = 0; bb < kMaxA; ++bb) acc[a][bb] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kMaxA], bv[kMaxA];
#pragma unroll
        for (int a = 0; a < kMaxA; ++a) {
          cv[a] = a < nA ? C_s[(ty + 16 * a) * ldn + n] : 0.f;
          bv[a] = a < nA ? B_s[(tx + 16 * a) * ldn + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kMaxA; ++a)
#pragma unroll
          for (int bb = 0; bb <= a; ++bb) acc[a][bb] += cv[a] * bv[bb];
      }
#pragma unroll
      for (int a = 0; a < kMaxA; ++a) {
        if (a >= nA) break;
        const int i = ty + 16 * a;
#pragma unroll
        for (int bb = 0; bb < kMaxA; ++bb) {
          if (bb >= nA) break;
          const int j = tx + 16 * bb;
          float g = 0.f;
          if (bb <= a && j <= i && i < ck)
            g = acc[a][bb] * expf(cs_s[i] - cs_s[j]);
          G_s[i * ldg + j] = g;
        }
      }
    }
    __syncthreads();

    // y = G (x dt) + exp(cs) * C S^T; rows g + 16a, state row r
    {
      const int r = tid % PT, g = tid / PT;
      float yd[kMaxA], yo[kMaxA];
#pragma unroll
      for (int a = 0; a < kMaxA; ++a) yd[a] = yo[a] = 0.f;
      const int jmax = min(ck, g + 16 * (nA - 1) + 1);  // G is 0 past row
      for (int j = 0; j < jmax; ++j) {
        const float xv = xd_s[j * PT + r];
#pragma unroll
        for (int a = 0; a < kMaxA; ++a)
          if (a < nA) yd[a] += G_s[(g + 16 * a) * ldg + j] * xv;
      }
      for (int n = 0; n < N; ++n) {
        const float sv = S_s[r * ldn + n];
#pragma unroll
        for (int a = 0; a < kMaxA; ++a)
          if (a < nA) yo[a] += C_s[(g + 16 * a) * ldn + n] * sv;
      }
      if (p0 + r < P) {
#pragma unroll
        for (int a = 0; a < kMaxA; ++a) {
          const int i = g + 16 * a;
          if (a < nA && i < ck)
            store_as(&y[((t0 + i) * H + h) * P + p0 + r],
                     yd[a] + ecs_s[i] * yo[a]);
        }
      }
    }
    __syncthreads();  // every thread has read the state it carries in

    // S = S * exp(cs_last) + ((x dt) * exp(cs_last - cs))^T B;
    // state row r = tid / 16, columns nl + 16m
    {
      const int r = tid / 16, nl = tid % 16;
      const float decay = ecs_s[ck - 1];
      float acc[kMaxN / 16];
#pragma unroll
      for (int m = 0; m < kMaxN / 16; ++m) acc[m] = 0.f;
      for (int j = 0; j < ck; ++j) {
        const float w = xd_s[j * PT + r] * dec_s[j];
#pragma unroll
        for (int m = 0; m < kMaxN / 16; ++m) {
          const int n = nl + 16 * m;
          if (n < N) acc[m] += w * B_s[j * ldn + n];
        }
      }
#pragma unroll
      for (int m = 0; m < kMaxN / 16; ++m) {
        const int n = nl + 16 * m;
        if (n < N) S_s[r * ldn + n] = S_s[r * ldn + n] * decay + acc[m];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < PT * N; e += kThreads) {
    const int r = e / N, n = e % N;
    if (p0 + r < P)
      store_as(&fin[(((size_t)b * H + h) * P + p0 + r) * N + n],
               S_s[r * ldn + n]);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* init, void* y, void* fin, int b, int l,
           int H, int P, int N, int ck, cudaStream_t stream) {
  if (b <= 0 || l <= 0 || H <= 0 || P <= 0 || N <= 0 || N > kMaxN ||
      ck <= 0 || ck > kMaxCk || l % ck != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = make_layout(ck, N).total * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((P + PT - 1) / PT, H, b);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(init),
      static_cast<T*>(y), static_cast<T*>(fin), l, H, P, N, ck);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/ssd_scan.py. Every tensor
// is contiguous and of one element type (dtype code of common.cuh):
// x (b,l,H,P), dt (b,l,H), A (H,), B and C (b,l,N), init (b,H,P,N) or null
// for a zero state; outputs y (b,l,H,P) and fin (b,H,P,N). Returns a
// cudaError_t code (0 = launched).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* init,
                        void* y, void* fin, int b, int l, int H, int P, int N,
                        int ck, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro_torch::kFloat32)
    return repro_torch::launch<float>(x, dt, A, Bm, Cm, init, y, fin, b, l, H,
                                      P, N, ck, s);
  if (dtype == repro_torch::kBFloat16)
    return repro_torch::launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, fin,
                                              b, l, H, P, N, ck, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory bytes a CTA needs at chunk ck and state width N.
extern "C" int ssd_scan_smem_bytes(int ck, int N) {
  return (int)(repro_torch::make_layout(ck, N).total * sizeof(float));
}

extern "C" int ssd_scan_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
