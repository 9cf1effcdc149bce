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
// What bounds it on the H100: bytes. At the mamba2-370m prefill shape (h 32,
// p 64, n 128, chunk 128) a 1024-token prompt reads and writes ~9.5 MB in
// bf16 (x, y, B, C, dt, the final state): 2.8 us over 3.35 TB/s, against
// ~1.4 GFLOP, 1.4 us at the bf16 tensor-core rate.
//
// What the design does: the chunks are independent except for the (P, N)
// state, so the scan is split into three launches, as kernels/ref.py
// ::ssd_reference writes the algorithm out (steps 1-4):
//  (a) chunk_state, one CTA per (chunk, head, batch row): scans dt * A over
//      the chunk (cs, written to a float32 scratch that (b) and (c) read)
//      and forms the chunk's local state ((x dt) * exp(cs_last - cs))^T B,
//      (P, N) in float32 scratch.
//  (b) state_passing, one thread per (batch row, head, p, n): walks the
//      chunks, S_c = S_{c-1} * exp(cs_last) + local_c from the initial
//      state (the loads of 8 chunks in flight together), writes the state
//      entering each chunk in the input type (as (c) multiplies it) and the
//      final state.
//  (c) chunk_scan, one CTA per (chunk, head, batch row): in bf16 each warp
//      forms 16 rows of C B^T in registers, masks them and scales them by L
//      there, and computes y = exp(cs) * (C S_prev^T) + G (x dt) for its
//      rows. In float32 the same products are dealt out by 16 x 8 tile,
//      evenly across the warps (the triangle's last strip is 8x its first,
//      and a lone warp on the CUDA cores is latency-bound), with G in shared
//      memory.
// At l = 1024 that is 256 CTAs in (a) and (c) for 132 SMs, where the
// sequential design walked 8 chunks in each of 128 CTAs.
//
// Products: in bf16 they run on the tensor cores (mma.sync m16n8k16, float32
// accumulation; operands loaded from shared memory by ldmatrix, G passed
// from the accumulator registers to the A operand without shared memory),
// with the roundings of ssd_pallas: x dt, the decay weights and G = (C B^T)
// o L are rounded to bf16 before their products (ssd_scan.py:54). float32
// runs the same structure on the CUDA cores in FMA (TF32 would miss
// test_ssd_sweep's 1e-4 + 1e-3 |y| bar). B, C, x and the entering state
// arrive by cp.async.
// Forming C B^T once per chunk and sharing it across heads was weighed: it
// costs each CTA ~1/3 of its tensor-core work (~1k mma.sync), and packing
// heads into a CTA would halve a grid that is barely two waves.
//
// The scan of dt * A adds in float32 but rounds each partial sum to the
// input type where the reference's bf16 cumsum rounds (in runs of 16 rows,
// then across runs; kernels/ref.py::_cumsum): over a 128-row chunk the sum
// reaches ~-100, where a bf16 step is 0.5. exp is only ever taken of
// cs_i - cs_j with i >= j (never the upper triangle, where it could
// overflow). In float32 every rounding is a no-op.
//
// Shared memory, rows padded by 16 bytes (ldmatrix and the float loops hit
// distinct banks): (c) holds C, B, x dt and the entering state, 107 KB in
// bf16 at ck = n = 128, p = 64 (two CTAs an SM), 205 KB in float32 (G
// takes B's place after C B^T is formed). Ragged chunks (ck not a multiple
// of 16), ragged P and N are zero-padded; ck <= 128 (in bf16 a warp's 16
// rows of C B^T live in 64 registers a thread) and N <= 128.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxCk = 128;    // chunk rows: 8 warps x 16
constexpr int kMaxN = 128;     // state width (float32 tiles fill shared memory)
constexpr int kRun = 16;       // rows a cumulative sum runs before it carries

// x rounded to T's precision (a no-op for float)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__host__ __device__ inline int pad16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Shared-memory layout of (a) and (c), in bytes. E is the element size.
struct Layout {
  int ckp, np, pp, ldn, ldp, ldg;  // padded sizes and row strides (elements)
  size_t c, b, xd, s, cs, ecs, dt, total;
};

__host__ __device__ inline Layout make_layout(int ck, int N, int P, int es,
                                              bool scan) {
  Layout L;
  const int pad = 16 / es;
  L.ckp = pad16(ck);
  L.np = pad16(N);
  L.pp = pad16(P);
  L.ldn = L.np + pad;
  L.ldp = L.pp + pad;
  L.ldg = L.ckp + 4;  // G in float32 (the float path of (c))
  size_t o = 0;
  L.c = o;
  if (scan) o += align16((size_t)L.ckp * L.ldn * es);
  L.b = o;
  size_t b_bytes = (size_t)L.ckp * L.ldn * es;
  if (scan && es == 4 && (size_t)L.ckp * L.ldg * 4 > b_bytes)
    b_bytes = (size_t)L.ckp * L.ldg * 4;
  o += align16(b_bytes);
  L.xd = o;
  o += align16((size_t)L.ckp * L.ldp * es);
  L.s = o;
  if (scan) o += align16((size_t)L.pp * L.ldn * es);
  L.cs = o;
  o += align16(L.ckp * 4);
  L.ecs = o;
  o += align16(L.ckp * 4);
  L.dt = o;
  o += align16(L.ckp * 4);
  L.total = o;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// rows x cols of src (row stride src_ld) into dst (row stride ld), by
// cp.async where rows are 16-byte aligned; the padding up to rows_pad x
// cols_pad is zeroed. Call __syncthreads() after cp_async_wait_all().
template <typename E>
__device__ void load_tile(E* dst, int ld, const E* src, size_t src_ld,
                          int rows, int cols, int rows_pad, int cols_pad) {
  constexpr int V = 16 / sizeof(E);
  const int tid = threadIdx.x;
  if (cols % V == 0 && src_ld % V == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int cv = cols / V;
    for (int e = tid; e < rows * cv; e += kThreads) {
      const int r = e / cv, c = (e % cv) * V;
      cp_async16(dst + (size_t)r * ld + c, src + r * src_ld + c);
    }
  } else {
    for (int e = tid; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e % cols;
      dst[(size_t)r * ld + c] = src[r * src_ld + c];
    }
  }
  if (rows < rows_pad || cols < cols_pad) {
    for (int e = tid; e < rows_pad * cols_pad; e += kThreads) {
      const int r = e / cols_pad, c = e % cols_pad;
      if (r >= rows || c >= cols) dst[(size_t)r * ld + c] = E(0.f);
    }
  }
}

// ---- 16-row strips of products, mma.sync (bf16) or FMA (float) ----------
//
// c[nt] (16 x 8, the m16n8 accumulator fragment: rows lane/4 and lane/4 + 8,
// columns 2 (lane % 4) and + 1 of tile nt) += A (16 x K) B (K x 8 columns of
// tile nt), for nt < ntiles. A(m, k) is A[m * lda + k] when A_K (K-major),
// else A[k * lda + m]; B(k, n) is B[n * ldb + k] when B_K, else
// B[k * ldb + n]. K is a multiple of 16; operands are zero past their data.

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the B fragment of tile nt at k-step k0 (bf16)
template <bool B_K>
__device__ __forceinline__ void load_b(uint32_t (&bf)[2], const bf16* B,
                                       int ldb, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  if (B_K)
    ldsm_x2(bf, B + (size_t)(n0 + lane % 8) * ldb + k0 + 8 * ((lane / 8) % 2));
  else
    ldsm_x2_t(bf, B + (size_t)(k0 + lane % 16) * ldb + n0);
}

template <int NT, bool A_K, bool B_K>
__device__ __forceinline__ void strip_mma(float (&c)[NT][4], const bf16* A,
                                          int lda, const bf16* B, int ldb,
                                          int K, int ntiles) {
  const int lane = threadIdx.x % 32;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    if (A_K)
      ldsm_x4(af, A + (size_t)(lane % 16) * lda + k0 + 8 * (lane / 16));
    else
      ldsm_x4_t(af, A + (size_t)(k0 + lane % 8 + 8 * (lane / 16)) * lda +
                        8 * ((lane / 8) % 2));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < ntiles) {
        uint32_t bf[2];
        load_b<B_K>(bf, B, ldb, k0, 8 * nt);
        mma_bf16(c[nt], af, bf);
      }
    }
  }
}

// float: two k-steps at a time, so that every shared-memory load is a
// float2 (a pair along k where the operand is K-major, along n where not)
template <bool K_MAJOR>
__device__ __forceinline__ float2 pair_k(const float* M, int ld, int row,
                                         int k) {
  if (K_MAJOR) return *reinterpret_cast<const float2*>(M + row * ld + k);
  return make_float2(M[k * ld + row], M[(k + 1) * ld + row]);
}

template <int NT, bool A_K, bool B_K>
__device__ __forceinline__ void strip_mma(float (&c)[NT][4], const float* A,
                                          int lda, const float* B, int ldb,
                                          int K, int ntiles) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // a single tile has little to overlap a load's latency with: unroll k
#pragma unroll(NT == 1 ? 4 : 1)
  for (int k = 0; k < K; k += 2) {
    const float2 a0 = pair_k<A_K>(A, lda, g, k);
    const float2 a1 = pair_k<A_K>(A, lda, g + 8, k);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < ntiles) {
        const int n = 8 * nt + 2 * t;
        float2 b0, b1;  // b0: column n at k, k + 1; b1: column n + 1
        if (B_K) {
          b0 = *reinterpret_cast<const float2*>(B + n * ldb + k);
          b1 = *reinterpret_cast<const float2*>(B + (n + 1) * ldb + k);
        } else {
          const float2 r0 = *reinterpret_cast<const float2*>(B + k * ldb + n);
          const float2 r1 =
              *reinterpret_cast<const float2*>(B + (k + 1) * ldb + n);
          b0 = make_float2(r0.x, r1.x);
          b1 = make_float2(r0.y, r1.y);
        }
        c[nt][0] = fmaf(a0.y, b0.y, fmaf(a0.x, b0.x, c[nt][0]));
        c[nt][1] = fmaf(a0.y, b1.y, fmaf(a0.x, b1.x, c[nt][1]));
        c[nt][2] = fmaf(a1.y, b0.y, fmaf(a1.x, b0.x, c[nt][2]));
        c[nt][3] = fmaf(a1.y, b1.y, fmaf(a1.x, b1.x, c[nt][3]));
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Warp 0: inclusive scan of dt * A over the chunk (dt_s, in shared memory:
// a lane's 16 loads from device memory would be issued one after the other)
// into cs_s, rounded where the reference rounds (ref.py::_cumsum): lane q
// sums run q of 16 rows in order, each partial sum rounded to T; a lane's
// offset is the rounded running sum of the earlier runs' totals.
template <typename T>
__device__ void chunk_cumsum(const float* dt_s, float a_h, int ck,
                             float* cs_s) {
  const int lane = threadIdx.x % 32, runs = (ck + kRun - 1) / kRun;
  float within[kRun];
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int i = lane * kRun + k;
    if (lane < runs && i < ck) {
      const float v = round_to<T>(dt_s[i] * a_h);
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
}

// (a) chunk_state: grid (chunks, H, b)
template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ A,
    const T* __restrict__ Bm, float* __restrict__ cs_g,
    float* __restrict__ st_g, int l, int H, int P, int N, int ck) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = make_layout(ck, N, P, sizeof(T), false);
  T* B_s = reinterpret_cast<T*>(smem + L.b);
  T* xw_s = reinterpret_cast<T*>(smem + L.xd);
  float* cs_s = reinterpret_cast<float*>(smem + L.cs);
  float* w_s = reinterpret_cast<float*>(smem + L.ecs);  // dt exp(last - cs)
  float* dt_s = reinterpret_cast<float*>(smem + L.dt);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x, warp = tid / 32;
  const size_t t0 = (size_t)b * l + (size_t)c * ck;

  load_tile(B_s, L.ldn, Bm + t0 * N, N, ck, N, L.ckp, L.np);
  load_tile(xw_s, L.ldp, x + t0 * H * P + (size_t)h * P, (size_t)H * P, ck, P,
            L.ckp, L.pp);
  for (int i = tid; i < ck; i += kThreads)
    dt_s[i] = to_float(dt[(t0 + i) * H + h]);
  __syncthreads();
  if (warp == 0) {
    chunk_cumsum<T>(dt_s, to_float(A[h]), ck, cs_s);
    const float last = cs_s[ck - 1];
    for (int i = tid; i < ck; i += 32) {
      cs_g[((size_t)b * H + h) * l + (size_t)c * ck + i] = cs_s[i];
      // last <= cs_i: cs falls
      w_s[i] = round_to<T>(expf(round_to<T>(last - cs_s[i])));
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // x -> (x dt) exp(cs_last - cs), rounded as ssd_pallas rounds
  for (int i = warp; i < ck; i += kThreads / 32)
    for (int p = tid % 32; p < P; p += 32) {
      T& v = xw_s[(size_t)i * L.ldp + p];
      v = T(round_to<T>(round_to<T>(to_float(v) * dt_s[i]) * w_s[i]));
    }
  __syncthreads();

  // local state (P x N) = xw^T B, dealt out by 16 x 8 tile
  const int mstrips = L.pp / 16, ntiles = L.np / 8, lane = tid % 32;
  float* out = st_g + (((size_t)b * nc + c) * H + h) * P * N;
  for (int t = warp; t < mstrips * ntiles; t += kThreads / 32) {
    const int p0 = 16 * (t % mstrips), n0 = 8 * (t / mstrips);
    float acc[1][4] = {};
    strip_mma<1, false, false>(acc, xw_s + p0, L.ldp, B_s + n0, L.ldn, L.ckp,
                               1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + lane / 4 + 8 * (e / 2);
      const int n = n0 + 2 * (lane % 4) + (e % 2);
      if (p < P && n < N) out[(size_t)p * N + n] = acc[0][e];
    }
  }
}

// (b) state_passing: one thread per (b, h, p, n); writes the state entering
// each chunk in T (as (c) multiplies it) and the final state
template <typename T>
__global__ void __launch_bounds__(kThreads) state_passing_kernel(
    const T* __restrict__ init, const float* __restrict__ cs_g,
    const float* __restrict__ st_g, T* __restrict__ prev, T* __restrict__ fin,
    int b_rows, int nc, int l, int H, int P, int N, int ck) {
  constexpr int U = 8;  // chunks whose loads are in flight together
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t per_b = (size_t)H * P * N;
  if (idx >= b_rows * per_b) return;
  const int b = idx / per_b;
  const size_t rest = idx % per_b;  // (h, p, n)
  const int h = rest / ((size_t)P * N);
  float s = init != nullptr ? to_float(init[idx]) : 0.f;
  const float* cs = cs_g + ((size_t)b * H + h) * l + ck - 1;
  for (int c0 = 0; c0 < nc; c0 += U) {
    float local[U], last[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      local[u] = c < nc ? st_g[((size_t)b * nc + c) * per_b + rest] : 0.f;
      last[u] = c < nc ? cs[(size_t)c * ck] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        store_as(&prev[((size_t)b * nc + c) * per_b + rest], s);
        s = s * round_to<T>(expf(last[u])) + local[u];
      }
    }
  }
  store_as(&fin[idx], s);
}

// (c) chunk_scan: grid (chunks, H, b)
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
    chunk_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ cs_g,
                      const T* __restrict__ prev, T* __restrict__ y,
                      int l, int H, int P, int N, int ck) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = make_layout(ck, N, P, sizeof(T), true);
  T* C_s = reinterpret_cast<T*>(smem + L.c);
  T* B_s = reinterpret_cast<T*>(smem + L.b);
  float* G_s = reinterpret_cast<float*>(smem + L.b);  // float path, after CB
  T* xd_s = reinterpret_cast<T*>(smem + L.xd);
  T* S_s = reinterpret_cast<T*>(smem + L.s);
  float* cs_s = reinterpret_cast<float*>(smem + L.cs);
  float* ecs_s = reinterpret_cast<float*>(smem + L.ecs);
  float* dt_s = reinterpret_cast<float*>(smem + L.dt);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x, warp = tid / 32;
  const int lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const size_t t0 = (size_t)b * l + (size_t)c * ck;

  load_tile(C_s, L.ldn, Cm + t0 * N, N, ck, N, L.ckp, L.np);
  load_tile(B_s, L.ldn, Bm + t0 * N, N, ck, N, L.ckp, L.np);
  load_tile(xd_s, L.ldp, x + t0 * H * P + (size_t)h * P, (size_t)H * P, ck, P,
            L.ckp, L.pp);
  load_tile(S_s, L.ldn, prev + (((size_t)b * nc + c) * H + h) * P * N, N, P,
            N, L.pp, L.np);  // the state entering the chunk
  for (int i = tid; i < L.ckp; i += kThreads) {
    const bool in = i < ck;
    const float v = in ? cs_g[((size_t)b * H + h) * l + (size_t)c * ck + i]
                       : 0.f;
    cs_s[i] = v;
    ecs_s[i] = in ? round_to<T>(expf(v)) : 0.f;
    dt_s[i] = in ? to_float(dt[(t0 + i) * H + h]) : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  for (int i = warp; i < ck; i += kThreads / 32)  // x -> x dt, rounded
    for (int p = lane; p < P; p += 32) {
      T& v = xd_s[(size_t)i * L.ldp + p];
      v = T(round_to<T>(to_float(v) * dt_s[i]));
    }

  // G(i, j) = (C B^T)(i, j) exp(cs_i - cs_j) for j <= i < ck, rounded as
  // ssd_pallas rounds (the segment sum, its exp and the product), else 0;
  // __expf (ex2.approx, ~2 ulp) is far inside both dtypes' tolerances
  auto gval = [&](int i, int j, float v) {
    if (j > i || i >= ck) return 0.f;
    return round_to<T>(v * round_to<T>(__expf(round_to<T>(cs_s[i] - cs_s[j]))));
  };
  const int nstrips = L.ckp / 16;
  if constexpr (sizeof(T) == 4) {
    // float, on the CUDA cores, where a lone warp is latency-bound: strip s
    // of 16 rows holds 2s + 2 tiles of C B^T and 16 (s + 1) k-steps of
    // G (x dt), so the work is dealt out by 16 x 8 tile, evenly, and G goes
    // through shared memory (in B's place once C B^T is formed)
    constexpr int kWarps = kThreads / 32;
    constexpr int kMaxTiles = (kMaxCk / 16) * (kMaxCk / 16 + 1) / kWarps;
    const int ntri = nstrips * (nstrips + 1);  // tiles on or below diagonal
    float cbt[kMaxTiles][1][4];
#pragma unroll
    for (int u = 0; u < kMaxTiles; ++u) {
      const int t = warp + u * kWarps;
#pragma unroll
      for (int e = 0; e < 4; ++e) cbt[u][0][e] = 0.f;
      if (t < ntri) {
        int st = 0;  // strip st holds tiles st (st + 1) .. (st + 1) (st + 2) - 1
        while ((st + 1) * (st + 2) <= t) ++st;
        strip_mma<1, true, true>(cbt[u], C_s + (size_t)16 * st * L.ldn, L.ldn,
                                 B_s + (size_t)8 * (t - st * (st + 1)) * L.ldn,
                                 L.ldn, L.np, 1);
      }
    }
    __syncthreads();  // x dt is ready; B is consumed
#pragma unroll
    for (int u = 0; u < kMaxTiles; ++u) {
      const int t = warp + u * kWarps;
      if (t < ntri) {
        int st = 0;
        while ((st + 1) * (st + 2) <= t) ++st;
        const int nt = t - st * (st + 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * st + gq + 8 * (e / 2);
          const int j = 8 * nt + 2 * tq + (e % 2);
          G_s[(size_t)i * L.ldg + j] = gval(i, j, cbt[u][0][e]);
        }
      }
    }
    __syncthreads();
    // y = exp(cs) * (C S_prev^T) + G (x dt), a 16 x 8 tile at a time
    const int ptiles = L.pp / 8;
    for (int t = warp; t < nstrips * ptiles; t += kWarps) {
      const int st = t / ptiles, pt = t % ptiles;
      float acc[1][4] = {};
      strip_mma<1, true, true>(acc, C_s + (size_t)16 * st * L.ldn, L.ldn,
                               S_s + (size_t)8 * pt * L.ldn, L.ldn, L.np, 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][e] *= ecs_s[16 * st + gq + 8 * (e / 2)];
      strip_mma<1, true, false>(acc, G_s + (size_t)16 * st * L.ldg, L.ldg,
                                xd_s + 8 * pt, L.ldp, 16 * (st + 1), 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * st + gq + 8 * (e / 2);
        const int p = 8 * pt + 2 * tq + (e % 2);
        if (i < ck && p < P) y[((t0 + i) * H + h) * P + p] = acc[0][e];
      }
    }
  } else {
    // bf16, on the tensor cores: this warp's 16 rows of C B^T (the tiles
    // that reach the diagonal) stay in registers and become the A operand
    // of G (x dt)
    const int r0 = 16 * warp;
    const bool has_rows = warp < nstrips;
    const int ctiles = 2 * warp + 2;
    float cb[16][4] = {};
    if (has_rows)
      strip_mma<16, true, true>(cb, C_s + (size_t)r0 * L.ldn, L.ldn, B_s,
                                L.ldn, L.np, ctiles);
    __syncthreads();  // x dt is ready
    if (!has_rows) return;
    const int i0 = r0 + gq, i1 = i0 + 8;
    for (int pg = 0; pg < L.pp; pg += 64) {
      const int ptiles = min(8, (L.pp - pg) / 8);
      float acc[8][4] = {};
      // exp(cs) * (C S_prev^T)
      strip_mma<8, true, true>(acc, C_s + (size_t)r0 * L.ldn, L.ldn,
                               S_s + (size_t)pg * L.ldn, L.ldn, L.np, ptiles);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] *= ecs_s[e < 2 ? i0 : i1];
      // + G (x dt), G's k-steps up to the diagonal
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk > warp) break;
        const int j0 = 16 * kk + 2 * tq, j1 = j0 + 8;
        uint32_t af[4];
        af[0] = pack_bf16(gval(i0, j0, cb[2 * kk][0]),
                          gval(i0, j0 + 1, cb[2 * kk][1]));
        af[1] = pack_bf16(gval(i1, j0, cb[2 * kk][2]),
                          gval(i1, j0 + 1, cb[2 * kk][3]));
        af[2] = pack_bf16(gval(i0, j1, cb[2 * kk + 1][0]),
                          gval(i0, j1 + 1, cb[2 * kk + 1][1]));
        af[3] = pack_bf16(gval(i1, j1, cb[2 * kk + 1][2]),
                          gval(i1, j1 + 1, cb[2 * kk + 1][3]));
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt < ptiles) {
            uint32_t bf[2];
            load_b<false>(bf, xd_s + pg, L.ldp, 16 * kk, 8 * nt);
            mma_bf16(acc[nt], af, bf);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? i0 : i1;
          const int p = pg + 8 * nt + 2 * tq + (e % 2);
          if (i < ck && p < P)
            store_as(&y[((t0 + i) * H + h) * P + p], acc[nt][e]);
        }
    }
  }
}

template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* init, void* y, void* fin, float* cs,
           float* st, void* prev, int b, int l, int H, int P, int N, int ck,
           cudaStream_t stream) {
  if (b <= 0 || l <= 0 || H <= 0 || P <= 0 || N <= 0 || N > kMaxN ||
      ck <= 0 || ck > kMaxCk || l % ck != 0)
    return (int)cudaErrorInvalidValue;
  const int nc = l / ck;
  const size_t smem_a = make_layout(ck, N, P, sizeof(T), false).total;
  const size_t smem_c = make_layout(ck, N, P, sizeof(T), true).total;
  cudaError_t err;
  if ((err = raise_smem(chunk_state_kernel<T>, smem_a)) ||
      (err = raise_smem(chunk_scan_kernel<T>, smem_c)))
    return (int)err;
  const dim3 grid(nc, H, b);
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  chunk_state_kernel<T><<<grid, kThreads, smem_a, stream>>>(
      xt, dtt, static_cast<const T*>(A), static_cast<const T*>(Bm), cs, st, l,
      H, P, N, ck);
  if ((err = cudaGetLastError())) return (int)err;
  const size_t states = (size_t)b * H * P * N;
  state_passing_kernel<T>
      <<<(unsigned)((states + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(static_cast<const T*>(init), cs, st, static_cast<T*>(prev),
                   static_cast<T*>(fin), b, nc, l, H, P, N, ck);
  if ((err = cudaGetLastError())) return (int)err;
  chunk_scan_kernel<T><<<grid, kThreads, smem_c, stream>>>(
      xt, dtt, static_cast<const T*>(Bm), static_cast<const T*>(Cm), cs,
      static_cast<const T*>(prev), static_cast<T*>(y), l, H, P, N, ck);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/ssd_scan.py. Every tensor
// is contiguous and of one element type (dtype code of common.cuh):
// x (b,l,H,P), dt (b,l,H), A (H,), B and C (b,l,N), init (b,H,P,N) or null
// for a zero state; outputs y (b,l,H,P) and fin (b,H,P,N); float32 scratch
// cs (b,H,l) and st (b,l/ck,H,P,N), and prev (b,l/ck,H,P,N) in the element
// type. Three launches on ``stream``. Returns a
// cudaError_t code (0 = launched).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* init,
                        void* y, void* fin, void* cs, void* st, void* prev,
                        int b, int l, int H, int P, int N, int ck, int dtype,
                        void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* csf = static_cast<float*>(cs);
  float* stf = static_cast<float*>(st);
  if (dtype == kFloat32)
    return launch<float>(x, dt, A, Bm, Cm, init, y, fin, csf, stf, prev, b, l,
                         H, P, N, ck, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, fin, csf, stf,
                                 prev, b, l, H, P, N, ck, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory bytes the larger of the two tiled kernels needs.
extern "C" int ssd_scan_smem_bytes(int ck, int N, int P, int dtype) {
  const int es = dtype == repro_torch::kFloat32 ? 4 : 2;
  return (int)repro_torch::make_layout(ck, N, P, es, true).total;
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
