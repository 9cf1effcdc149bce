// The RASK objective and its gradient: K candidate decision vectors A (K, D)
// become per-service weighted SLO fulfilment (K, S), and a cotangent
// ct (K, S) becomes dJ/dA (K, D).
//
// Replaces the TPU kernel repro/kernels/rask_objective.py
// ::rask_objective_pallas (body _kernel), and gives its jnp backward
// rask_objective_grad a kernel of its own: the PGD solve calls the backward
// once an ascent step and the forward once more to score the finals.
//
// Per candidate: gather each relation's features out of the decision vector
// and divide by x_scale; evaluate the stacked polynomials (powers by
// repeated products, an exponent of 0 gives exactly 1, so padded features
// and terms drop out); a branch-free per-SLO phi = min(num / den, 1) (kind
// 0 reads a parameter, kind 1 divides by max(rps * target, 1e-9)); a
// per-service segment sum. The backward retraces it: the per-SLO cotangent
// goes to the parameters (slo_pidx) and the predictions (slo_ridx), the
// product rule runs over the product of the OTHER features, and the
// per-feature cotangent goes back to the decision vector (rel_gather).
//
// What bounds it on the H100: neither bytes nor flops. At the paper's sizes
// (D <= 63, R <= 27, T = 10, F <= 3, Q <= 63) a call reads a few KB and
// does a few thousand flops: its bound is well under a microsecond, so a
// launch costs more than the work. The TPU kernel turns every gather and
// scatter into a one-hot matmul for the MXU; on the card indexed loads from
// shared memory are what is cheap, so this kernel carries none of them.
//
// Design (one CTA per candidate row, 256 threads; every chain short):
//  * Staging in one round trip: the row, its cotangent and every table are
//    copied into shared memory by cp.async (16-byte copies where the source
//    is 16-byte aligned, 4-byte otherwise), the tables dealt out to the 8
//    warps so that every copy is in flight at once, then one wait and one
//    barrier. Sizes come from the shapes at launch
//    (rask_objective_smem_bytes); above 48 KB the limit is raised once per
//    device, and the wrapper refuses shapes past the card's opt-in maximum
//    with a clear error (fleets of hundreds of services fit).
//  * Small code: a call runs each instruction once or a few times, so an
//    instruction fetched from L2 costs as much as the work. The kernels are
//    instantiated per feature count F (1..8, chosen at launch), so the
//    per-feature loops unroll exactly, and every loop with a runtime bound
//    stays rolled (on the H100 the first version of this kernel, whose copy
//    loops the compiler had unrolled, spent most of its time staging).
//  * A group of lanes per relation (a power of two, up to 32, so that all
//    relations fit the CTA at once): a lane per term, its features read
//    and scaled by the lane itself, the terms summed by a fixed-order
//    shuffle tree (predict in the forward). In the backward the same group
//    carries on with no barrier: it sums the cotangents of its own
//    relation's SLOs (lanes strided over the SLO table), then runs the
//    product rule over the OTHER features lane by term, each feature's sum
//    another shuffle tree. Meanwhile the top threads of the CTA form each
//    parameter SLO's cotangent and the index it feeds.
//  * A group of lanes per decision index sums its contributors: the
//    parameter SLOs that feed it, then the feature slots that gather it,
//    each lane a strided share of the table, then a shuffle tree. With one
//    CTA per candidate a per-index list would be used once, so the groups
//    scan the tables (Q + R*F entries split 4 to 32 ways) instead of
//    building lists.
//  * Two barriers in the backward (after staging, before the per-index
//    sums), three in the forward. Every sum runs in a fixed order, with no
//    atomics, so a decide is reproducible from run to run; indices repeat
//    (relations of one service share `cores`, padded features re-read
//    index 0), which is why the backward gathers per output index instead
//    of scattering;
//  * an index outside its table reads NaN, so a bad table shows in the
//    result instead of reading stray memory.
// Float32 throughout, like the original.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxF = 8;  // features per relation (one instantiation each)

struct Dims {
  int K, D, R, F, T, Q, S;
};

// Shared-memory layout in 4-byte words (int or float), every segment on a
// 16-byte boundary; one function for the kernels and for the launch size.
struct Layout {
  int a, rel, xscale, w, tm, exps, kind, svc, weight, target, pidx, ridx,
      rps, preds, q, ct, dx, tgt, total;
};

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline Layout make_layout(const Dims& d, bool backward) {
  Layout L;
  int o = 0;
  L.a = o;      o += pad4(d.D);
  L.rel = o;    o += pad4(d.R * d.F);
  L.xscale = o; o += pad4(d.R * d.F);
  L.w = o;      o += pad4(d.R * d.T);
  L.tm = o;     o += pad4(d.R * d.T);
  L.exps = o;   o += pad4(d.R * d.T * d.F);
  L.kind = o;   o += pad4(d.Q);
  L.svc = o;    o += pad4(d.Q);
  L.weight = o; o += pad4(d.Q);
  L.target = o; o += pad4(d.Q);
  L.pidx = o;   o += pad4(d.Q);
  L.ridx = o;   o += pad4(d.Q);
  L.rps = o;    o += pad4(d.S);
  L.preds = o;  o += pad4(d.R);
  L.q = o;      o += pad4(d.Q);  // weight * phi; a parameter SLO's dnumer
  L.ct = L.dx = L.tgt = o;
  if (backward) {
    L.ct = o;   o += pad4(d.S);
    L.dx = o;   o += pad4(d.R * d.F);
    L.tgt = o;  o += pad4(d.Q);  // the index a parameter SLO feeds, or -1
  }
  L.total = o;
  return L;
}

struct Tables {
  const int* rel_gather;
  const float* w;
  const int* exponents;
  const float* term_mask;
  const float* x_scale;
  const int* slo_kind;
  const int* slo_service;
  const float* slo_weight;
  const float* slo_target;
  const int* slo_pidx;
  const int* slo_ridx;
  const float* rps;
};

__device__ __forceinline__ float at(const float* v, int i, int n) {
  return (unsigned)i < (unsigned)n ? v[i] : __int_as_float(0x7fc00000);
}

// x^e by repeated products: the multiplication order of repro's cumprod
__device__ __forceinline__ float ipow(float x, int e) {
  float p = 1.f;
#pragma unroll 1
  for (int i = 0; i < e; ++i) p *= x;
  return p;
}

// min(r, 1) that keeps a NaN (fminf would drop it; jnp.minimum keeps it)
__device__ __forceinline__ float clip1(float r) { return r > 1.f ? 1.f : r; }

// max(v, 1e-9) that keeps a NaN, as jnp.maximum does
__device__ __forceinline__ float floor_denom(float v) {
  return v < 1e-9f ? 1e-9f : v;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Issue (not wait for) this warp's copy of n 4-byte words to a 16-byte
// aligned shared-memory segment: 16-byte copies where the source is
// 16-byte aligned too, 4-byte otherwise. Loops stay rolled: the kernel is
// bound by latency, and unrolled copies of cold code cost an instruction
// fetch from L2 per line.
__device__ __forceinline__ void copy_async(float* dst, const void* src,
                                           int n) {
  const float* s = static_cast<const float*>(src);
  const int lane = threadIdx.x % 32;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = n & ~3;
#pragma unroll 1
    for (int i = 4 * lane; i < done; i += 4 * 32) cp_async16(dst + i, s + i);
  }
#pragma unroll 1
  for (int i = done + lane; i < n; i += 32) cp_async4(dst + i, s + i);
}

// Stage row k of A (and of the cotangent, for the backward) and every
// table in shared memory: the segments dealt out to the warps, every copy
// in flight at once, one wait.
__device__ void stage(float* sm, const Layout& L, const Dims& d,
                      const float* A, const float* ct, int k,
                      const Tables& t) {
  switch (threadIdx.x / 32) {
    case 0:
      copy_async(sm + L.a, A + (size_t)k * d.D, d.D);
      copy_async(sm + L.kind, t.slo_kind, d.Q);
      break;
    case 1:
      copy_async(sm + L.rel, t.rel_gather, d.R * d.F);
      copy_async(sm + L.svc, t.slo_service, d.Q);
      break;
    case 2:
      copy_async(sm + L.xscale, t.x_scale, d.R * d.F);
      copy_async(sm + L.weight, t.slo_weight, d.Q);
      break;
    case 3:
      copy_async(sm + L.w, t.w, d.R * d.T);
      copy_async(sm + L.target, t.slo_target, d.Q);
      break;
    case 4:
      copy_async(sm + L.tm, t.term_mask, d.R * d.T);
      copy_async(sm + L.pidx, t.slo_pidx, d.Q);
      break;
    case 5:
      copy_async(sm + L.exps, t.exponents, d.R * d.T * d.F);
      break;
    case 6:
      copy_async(sm + L.ridx, t.slo_ridx, d.Q);
      copy_async(sm + L.rps, t.rps, d.S);
      break;
    default:
      if (ct != nullptr) copy_async(sm + L.ct, ct + (size_t)k * d.S, d.S);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// The CTA cut into groups of lanes for n items: a group is a power of two
// of lanes, up to `want` (rounded up) and 32, and small enough that all n
// groups fit the CTA at once when they can. Shifts, not divisions.
struct Groups {
  int width, count, id, lane;  // lanes a group, groups, this thread's
};

__device__ __forceinline__ Groups groups_of(int n, int want) {
  int up = 0;
#pragma unroll 1
  while ((1 << up) < want && up < 5) ++up;
  int lg = 0;
#pragma unroll 1
  while (lg < up && (2 << lg) * n <= kThreads) ++lg;
  return {1 << lg, kThreads >> lg, (int)threadIdx.x >> lg,
          (int)threadIdx.x & ((1 << lg) - 1)};
}

// Sum over the `width` lanes of a group, a fixed-order shuffle tree; every
// lane of the warp takes part.
__device__ __forceinline__ float group_sum(float x, int width) {
#pragma unroll 1
  for (int o = width >> 1; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// group_sum of N values at once: the same trees, level by level, so that
// the N shuffles of a level are in flight together.
template <int N>
__device__ __forceinline__ void group_sum(float (&x)[N], int width) {
#pragma unroll 1
  for (int o = width >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] += __shfl_xor_sync(0xffffffffu, x[i], o);
  }
}

// Relation r's F scaled features: the forward divides as repro's
// reference does; the backward multiplies by the reciprocal as repro's
// rask_objective_grad does.
// The backward keeps the reciprocals in xinv for the features' cotangents.
template <int F>
__device__ __forceinline__ void features(const float* sm, const Layout& L,
                                         const Dims& d, int r,
                                         bool reciprocal, float (&x)[F],
                                         float (&xinv)[F]) {
  const int* smi = reinterpret_cast<const int*>(sm);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float a = at(sm + L.a, smi[L.rel + r * F + f], d.D);
    const float s = sm[L.xscale + r * F + f];
    xinv[f] = 1.f / s;
    x[f] = reciprocal ? a * xinv[f] : a / s;
  }
}

// Relation r's features into x, and this lane's share of its prediction:
// terms t, t + width, ... (the group sums the shares).
template <int F>
__device__ __forceinline__ float terms_share(const float* sm, const Layout& L,
                                             const Dims& d, int r, int t,
                                             int width, bool reciprocal,
                                             float (&x)[F], float (&xinv)[F]) {
  const int* smi = reinterpret_cast<const int*>(sm);
  features<F>(sm, L, d, r, reciprocal, x, xinv);
  float pred = 0.f;
#pragma unroll 1
  for (int tt = t; tt < d.T; tt += width) {
    const int* e = smi + L.exps + (r * d.T + tt) * F;
    float term = 1.f;
#pragma unroll
    for (int f = 0; f < F; ++f) term *= ipow(x[f], e[f]);
    pred += term * (sm[L.w + r * d.T + tt] * sm[L.tm + r * d.T + tt]);
  }
  return pred;
}

// One prediction per relation: a group of lanes a relation, a lane a term.
template <int F>
__device__ void predict(float* sm, const Layout& L, const Dims& d) {
  const Groups grp = groups_of(d.R, d.T);
  const int width = grp.width, t = grp.lane;
#pragma unroll 1
  for (int base = 0; base < d.R; base += grp.count) {  // uniform in the CTA
    const int r = base + grp.id;
    float x[F], xinv[F];
    float pred =
        r < d.R ? terms_share<F>(sm, L, d, r, t, width, false, x, xinv) : 0.f;
    pred = group_sum(pred, width);
    if (r < d.R && t == 0) sm[L.preds + r] = pred;
  }
  __syncthreads();
}

// SLO q's cotangent on its numerator: ct[svc] * weight * d min(ratio, 1) /
// denom, with the half-subgradient at ratio == 1
__device__ __forceinline__ float dnumer(const float* sm, const Layout& L,
                                        const Dims& d, int q, float numer) {
  const int* smi = reinterpret_cast<const int*>(sm);
  const int kind = smi[L.kind + q];
  const int svc = smi[L.svc + q];
  const float target = sm[L.target + q];
  const float denom =
      kind == 1 ? floor_denom(at(sm + L.rps, svc, d.S) * target) : target;
  const float ratio = numer / denom;
  const float clip = ratio < 1.f ? 1.f : (ratio == 1.f ? 0.5f : 0.f);
  return at(sm + L.ct, svc, d.S) * sm[L.weight + q] * clip / denom;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    rask_forward_kernel(const float* __restrict__ A, Tables t,
                        float* __restrict__ out, Dims d) {
  extern __shared__ __align__(16) float sm[];
  const Layout L = make_layout(d, false);
  const int* smi = reinterpret_cast<const int*>(sm);
  const int k = blockIdx.x;
  stage(sm, L, d, A, nullptr, k, t);
  predict<F>(sm, L, d);

#pragma unroll 1
  for (int q = threadIdx.x; q < d.Q; q += kThreads) {
    const int kind = smi[L.kind + q];
    const float numer = kind == 0 ? at(sm + L.a, smi[L.pidx + q], d.D)
                                  : at(sm + L.preds, smi[L.ridx + q], d.R);
    const float target = sm[L.target + q];
    const float denom =
        kind == 1 ? floor_denom(at(sm + L.rps, smi[L.svc + q], d.S) * target)
                  : target;
    sm[L.q + q] = sm[L.weight + q] * clip1(numer / denom);
  }
  __syncthreads();

  // segment sum, SLOs in table order
#pragma unroll 1
  for (int s = threadIdx.x; s < d.S; s += kThreads) {
    float acc = 0.f;
#pragma unroll 1
    for (int q = 0; q < d.Q; ++q)
      if (smi[L.svc + q] == s) acc += sm[L.q + q];
    out[(size_t)k * d.S + s] = acc;
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    rask_backward_kernel(const float* __restrict__ A,
                         const float* __restrict__ ct, Tables t,
                         float* __restrict__ dA, Dims d) {
  extern __shared__ __align__(16) float sm[];
  const Layout L = make_layout(d, true);
  int* smi = reinterpret_cast<int*>(sm);
  const int k = blockIdx.x;
  stage(sm, L, d, A, ct, k, t);

  // parameter SLOs, a thread each from the top of the CTA (lanes the
  // relation groups leave idle): the cotangent and the index it feeds
#pragma unroll 1
  for (int q = kThreads - 1 - threadIdx.x; q < d.Q; q += kThreads) {
    const int i = smi[L.pidx + q];
    const bool feeds = smi[L.kind + q] == 0 && (unsigned)i < (unsigned)d.D;
    smi[L.tgt + q] = feeds ? i : -1;
    sm[L.q + q] = feeds ? dnumer(sm, L, d, q, sm[L.a + i]) : 0.f;
  }

  // per relation, one group of lanes from the prediction to the features'
  // cotangents with no barrier between: the prediction (a lane a term),
  // its cotangent (its SLOs, lanes strided over the SLO table), then the
  // product rule over the OTHER features, a lane a term
  {
    const Groups grp = groups_of(d.R, d.T);
    const int width = grp.width, t = grp.lane;
#pragma unroll 1
    for (int base = 0; base < d.R; base += grp.count) {  // uniform in the CTA
      const int r = base + grp.id;
      float x[F], xinv[F];
      float pred =
          r < d.R ? terms_share<F>(sm, L, d, r, t, width, true, x, xinv)
                  : 0.f;
      pred = group_sum(pred, width);
      float dpred = 0.f;
      if (r < d.R) {
#pragma unroll 1
        for (int q = t; q < d.Q; q += width)
          if (smi[L.kind + q] != 0 && smi[L.ridx + q] == r)
            dpred += dnumer(sm, L, d, q, pred);
      }
      dpred = group_sum(dpred, width);
      float dx[F];
#pragma unroll
      for (int f = 0; f < F; ++f) dx[f] = 0.f;
      if (r < d.R) {
#pragma unroll 1
        for (int tt = t; tt < d.T; tt += width) {
          const int* e = smi + L.exps + (r * d.T + tt) * F;
          const float dterm =
              dpred * (sm[L.w + r * d.T + tt] * sm[L.tm + r * d.T + tt]);
          float vals[F], dvals[F];
#pragma unroll
          for (int f = 0; f < F; ++f) {
            vals[f] = ipow(x[f], e[f]);
            dvals[f] = e[f] > 0 ? (float)e[f] * ipow(x[f], e[f] - 1) : 0.f;
          }
#pragma unroll
          for (int f = 0; f < F; ++f) {
            float other = 1.f;
#pragma unroll
            for (int f2 = 0; f2 < F; ++f2)
              if (f2 != f) other *= vals[f2];
            dx[f] += dterm * dvals[f] * other;
          }
        }
      }
      group_sum(dx, width);
#pragma unroll
      for (int f = 0; f < F; ++f)
        if (r < d.R && (f & (width - 1)) == t)
          sm[L.dx + r * F + f] = dx[f] * xinv[f];
    }
  }
  __syncthreads();

  // per decision index: the parameter SLOs' share, then the features'
  {
    const Groups grp = groups_of(d.D, 32);
    const int width = grp.width, t = grp.lane;
#pragma unroll 1
    for (int base = 0; base < d.D; base += grp.count) {
      const int i = base + grp.id;
      float from_slo = 0.f, from_features = 0.f;
      if (i < d.D) {
#pragma unroll 1
        for (int q = t; q < d.Q; q += width)
          if (smi[L.tgt + q] == i) from_slo += sm[L.q + q];
#pragma unroll 1
        for (int j = t; j < d.R * F; j += width)
          if (smi[L.rel + j] == i) from_features += sm[L.dx + j];
      }
      float sums[2] = {from_slo, from_features};
      group_sum(sums, width);
      if (i < d.D && t == 0) dA[(size_t)k * d.D + i] = sums[0] + sums[1];
    }
  }
}

__global__ void empty_kernel() {}

// Checks the sizes and the shared memory they need; raises the kernel's
// dynamic shared-memory limit the first time a size needs more than 48 KB
// on a device (and never again for sizes that fit what was raised).
template <typename Kernel>
int prepare(Kernel kernel, const Dims& d, bool backward, size_t* smem,
            int* raised) {
  if (d.K <= 0 || d.D <= 0 || d.R <= 0 || d.F <= 0 || d.F > kMaxF ||
      d.T <= 0 || d.Q <= 0 || d.S <= 0)
    return (int)cudaErrorInvalidValue;
  *smem = (size_t)make_layout(d, backward).total * 4;
  if (*smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if ((int)*smem > raised[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
      if (err != cudaSuccess) return (int)err;
      raised[dev] = (int)*smem;
    }
  }
  return 0;
}

// What a kernel instantiation has raised its limit to, per device.
int raised_forward[kMaxF + 1][64] = {};
int raised_backward[kMaxF + 1][64] = {};

template <int F>
int launch_forward(const float* A, const Tables& t, float* out,
                   const Dims& d, cudaStream_t stream) {
  size_t smem = 0;
  const int err = prepare(rask_forward_kernel<F>, d, false, &smem,
                          raised_forward[F]);
  if (err) return err;
  rask_forward_kernel<F><<<d.K, kThreads, smem, stream>>>(A, t, out, d);
  return (int)cudaGetLastError();
}

template <int F>
int launch_backward(const float* A, const float* ct, const Tables& t,
                    float* dA, const Dims& d, cudaStream_t stream) {
  size_t smem = 0;
  const int err = prepare(rask_backward_kernel<F>, d, true, &smem,
                          raised_backward[F]);
  if (err) return err;
  rask_backward_kernel<F><<<d.K, kThreads, smem, stream>>>(A, ct, t, dA, d);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/rask_objective.py. Every
// tensor is contiguous; float32 except the int32 index tables. Each entry
// returns a cudaError_t code (0 = launched).

extern "C" int rask_objective_smem_bytes(int D, int R, int F, int T, int Q,
                                         int S, int backward) {
  repro_torch::Dims d{1, D, R, F, T, Q, S};
  return repro_torch::make_layout(d, backward != 0).total * 4;
}

extern "C" int rask_objective_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

extern "C" int rask_objective_max_features() { return repro_torch::kMaxF; }

extern "C" int rask_objective_forward(
    const float* A, const int* rel_gather, const float* w,
    const int* exponents, const float* term_mask, const float* x_scale,
    const int* slo_kind, const int* slo_service, const float* slo_weight,
    const float* slo_target, const int* slo_pidx, const int* slo_ridx,
    const float* rps, float* out, int K, int D, int R, int F, int T, int Q,
    int S, void* stream) {
  using namespace repro_torch;
  const Dims d{K, D, R, F, T, Q, S};
  const Tables t{rel_gather, w, exponents, term_mask, x_scale, slo_kind,
                 slo_service, slo_weight, slo_target, slo_pidx, slo_ridx,
                 rps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_forward<1>(A, t, out, d, s);
    case 2: return launch_forward<2>(A, t, out, d, s);
    case 3: return launch_forward<3>(A, t, out, d, s);
    case 4: return launch_forward<4>(A, t, out, d, s);
    case 5: return launch_forward<5>(A, t, out, d, s);
    case 6: return launch_forward<6>(A, t, out, d, s);
    case 7: return launch_forward<7>(A, t, out, d, s);
    case 8: return launch_forward<8>(A, t, out, d, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int rask_objective_backward(
    const float* A, const float* ct, const int* rel_gather, const float* w,
    const int* exponents, const float* term_mask, const float* x_scale,
    const int* slo_kind, const int* slo_service, const float* slo_weight,
    const float* slo_target, const int* slo_pidx, const int* slo_ridx,
    const float* rps, float* dA, int K, int D, int R, int F, int T, int Q,
    int S, void* stream) {
  using namespace repro_torch;
  const Dims d{K, D, R, F, T, Q, S};
  const Tables t{rel_gather, w, exponents, term_mask, x_scale, slo_kind,
                 slo_service, slo_weight, slo_target, slo_pidx, slo_ridx,
                 rps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_backward<1>(A, ct, t, dA, d, s);
    case 2: return launch_backward<2>(A, ct, t, dA, d, s);
    case 3: return launch_backward<3>(A, ct, t, dA, d, s);
    case 4: return launch_backward<4>(A, ct, t, dA, d, s);
    case 5: return launch_backward<5>(A, ct, t, dA, d, s);
    case 6: return launch_backward<6>(A, ct, t, dA, d, s);
    case 7: return launch_backward<7>(A, ct, t, dA, d, s);
    case 8: return launch_backward<8>(A, ct, t, dA, d, s);
  }
  return (int)cudaErrorInvalidValue;
}

// An empty kernel of one CTA: chip_smoke.py times it as the practical floor
// of one launch on this card.
extern "C" int rask_objective_empty(void* stream) {
  repro_torch::empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* rask_objective_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
