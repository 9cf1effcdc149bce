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
// Design (simple first):
//  * one CTA per candidate row; 128 threads;
//  * the row and every table are staged in shared memory, sized from the
//    shapes at launch (rask_objective_smem_bytes); above 48 KB the launch
//    raises the limit, and the wrapper refuses shapes past the card's
//    opt-in maximum with a clear error (fleets of hundreds of services fit);
//  * a thread per relation evaluates its polynomial, a thread per SLO its
//    phi, a thread per service (forward) or per decision index (backward)
//    its sum. Every sum runs over a fixed order (SLOs and relations in
//    table order), with no atomics, so a decide is reproducible from run
//    to run. Indices repeat (relations of one service share `cores`, padded
//    features re-read index 0), which is why the backward gathers per
//    output index instead of scattering;
//  * an index outside its table reads NaN, so a bad table shows in the
//    result instead of reading stray memory.
// Float32 throughout, like the original.

#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kMaxF = 8;  // features per relation (registers of a thread)

struct Dims {
  int K, D, R, F, T, Q, S;
};

// Shared-memory layout in 4-byte words (int or float), one function for the
// kernels and for the launch size.
struct Layout {
  int a, rel, xscale, wm, exps, kind, svc, weight, target, pidx, ridx, rps, x,
      preds, q, ct, dpreds, dx, total;
};

__host__ __device__ inline Layout make_layout(const Dims& d, bool backward) {
  Layout L;
  int o = 0;
  L.a = o;      o += d.D;
  L.rel = o;    o += d.R * d.F;
  L.xscale = o; o += d.R * d.F;
  L.wm = o;     o += d.R * d.T;
  L.exps = o;   o += d.R * d.T * d.F;
  L.kind = o;   o += d.Q;
  L.svc = o;    o += d.Q;
  L.weight = o; o += d.Q;
  L.target = o; o += d.Q;
  L.pidx = o;   o += d.Q;
  L.ridx = o;   o += d.Q;
  L.rps = o;    o += d.S;
  L.x = o;      o += d.R * d.F;
  L.preds = o;  o += d.R;
  L.q = o;      o += d.Q;  // weight * phi (forward), dnumer (backward)
  L.ct = L.dpreds = L.dx = o;
  if (backward) {
    L.ct = o;     o += d.S;
    L.dpreds = o; o += d.R;
    L.dx = o;     o += d.R * d.F;
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
  for (int i = 0; i < e; ++i) p *= x;
  return p;
}

// min(r, 1) that keeps a NaN (fminf would drop it; jnp.minimum keeps it)
__device__ __forceinline__ float clip1(float r) { return r > 1.f ? 1.f : r; }

// max(v, 1e-9) that keeps a NaN, as jnp.maximum does
__device__ __forceinline__ float floor_denom(float v) {
  return v < 1e-9f ? 1e-9f : v;
}

// Stage row k of A and every table in shared memory.
__device__ void stage(float* sm, const Layout& L, const Dims& d,
                      const float* A, int k, const Tables& t) {
  int* smi = reinterpret_cast<int*>(sm);
  for (int i = threadIdx.x; i < d.D; i += kThreads)
    sm[L.a + i] = A[(size_t)k * d.D + i];
  for (int i = threadIdx.x; i < d.R * d.F; i += kThreads) {
    smi[L.rel + i] = t.rel_gather[i];
    sm[L.xscale + i] = t.x_scale[i];
  }
  for (int i = threadIdx.x; i < d.R * d.T; i += kThreads)
    sm[L.wm + i] = t.w[i] * t.term_mask[i];
  for (int i = threadIdx.x; i < d.R * d.T * d.F; i += kThreads)
    smi[L.exps + i] = t.exponents[i];
  for (int i = threadIdx.x; i < d.Q; i += kThreads) {
    smi[L.kind + i] = t.slo_kind[i];
    smi[L.svc + i] = t.slo_service[i];
    sm[L.weight + i] = t.slo_weight[i];
    sm[L.target + i] = t.slo_target[i];
    smi[L.pidx + i] = t.slo_pidx[i];
    smi[L.ridx + i] = t.slo_ridx[i];
  }
  for (int i = threadIdx.x; i < d.S; i += kThreads) sm[L.rps + i] = t.rps[i];
}

// Scaled features, then one prediction per relation.
__device__ void predict(float* sm, const Layout& L, const Dims& d,
                        bool reciprocal) {
  const int* smi = reinterpret_cast<const int*>(sm);
  for (int i = threadIdx.x; i < d.R * d.F; i += kThreads) {
    const float a = at(sm + L.a, smi[L.rel + i], d.D);
    // the forward divides as repro's reference does; the backward
    // multiplies by the reciprocal as repro's rask_objective_grad does
    sm[L.x + i] = reciprocal ? a * (1.f / sm[L.xscale + i])
                             : a / sm[L.xscale + i];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < d.R; r += kThreads) {
    float pred = 0.f;
    for (int t = 0; t < d.T; ++t) {
      const int* e = smi + L.exps + (r * d.T + t) * d.F;
      float term = 1.f;
      for (int f = 0; f < d.F; ++f) term *= ipow(sm[L.x + r * d.F + f], e[f]);
      pred += term * sm[L.wm + r * d.T + t];
    }
    sm[L.preds + r] = pred;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    rask_forward_kernel(const float* __restrict__ A, Tables t,
                        float* __restrict__ out, Dims d) {
  extern __shared__ float sm[];
  const Layout L = make_layout(d, false);
  const int* smi = reinterpret_cast<const int*>(sm);
  const int k = blockIdx.x;
  stage(sm, L, d, A, k, t);
  __syncthreads();
  predict(sm, L, d, false);

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
  for (int s = threadIdx.x; s < d.S; s += kThreads) {
    float acc = 0.f;
    for (int q = 0; q < d.Q; ++q)
      if (smi[L.svc + q] == s) acc += sm[L.q + q];
    out[(size_t)k * d.S + s] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    rask_backward_kernel(const float* __restrict__ A,
                         const float* __restrict__ ct, Tables t,
                         float* __restrict__ dA, Dims d) {
  extern __shared__ float sm[];
  const Layout L = make_layout(d, true);
  const int* smi = reinterpret_cast<const int*>(sm);
  const int k = blockIdx.x;
  stage(sm, L, d, A, k, t);
  for (int s = threadIdx.x; s < d.S; s += kThreads)
    sm[L.ct + s] = ct[(size_t)k * d.S + s];
  __syncthreads();
  predict(sm, L, d, true);

  // per SLO: dnumer = ct[svc] * weight * d min(ratio, 1) / denom, with the
  // half-subgradient at ratio == 1
  for (int q = threadIdx.x; q < d.Q; q += kThreads) {
    const int kind = smi[L.kind + q];
    const int svc = smi[L.svc + q];
    const float numer = kind == 0 ? at(sm + L.a, smi[L.pidx + q], d.D)
                                  : at(sm + L.preds, smi[L.ridx + q], d.R);
    const float target = sm[L.target + q];
    const float denom =
        kind == 1 ? floor_denom(at(sm + L.rps, svc, d.S) * target) : target;
    const float ratio = numer / denom;
    const float clip = ratio < 1.f ? 1.f : (ratio == 1.f ? 0.5f : 0.f);
    sm[L.q + q] = at(sm + L.ct, svc, d.S) * sm[L.weight + q] * clip / denom;
  }
  __syncthreads();

  // per relation: its prediction's cotangent, then the product rule
  for (int r = threadIdx.x; r < d.R; r += kThreads) {
    float dpred = 0.f;
    for (int q = 0; q < d.Q; ++q)
      if (smi[L.kind + q] != 0 && smi[L.ridx + q] == r) dpred += sm[L.q + q];
    const float* x = sm + L.x + r * d.F;
    float dx[kMaxF];
    for (int f = 0; f < d.F; ++f) dx[f] = 0.f;
    for (int t = 0; t < d.T; ++t) {
      const int* e = smi + L.exps + (r * d.T + t) * d.F;
      const float dterm = dpred * sm[L.wm + r * d.T + t];
      float vals[kMaxF], dvals[kMaxF];
      for (int f = 0; f < d.F; ++f) {
        vals[f] = ipow(x[f], e[f]);
        dvals[f] = e[f] > 0 ? (float)e[f] * ipow(x[f], e[f] - 1) : 0.f;
      }
      for (int f = 0; f < d.F; ++f) {
        float other = 1.f;
        for (int f2 = 0; f2 < d.F; ++f2)
          if (f2 != f) other *= vals[f2];
        dx[f] += dterm * dvals[f] * other;
      }
    }
    for (int f = 0; f < d.F; ++f)
      sm[L.dx + r * d.F + f] = dx[f] * (1.f / sm[L.xscale + r * d.F + f]);
  }
  __syncthreads();

  // per decision index: the parameter SLOs' share, then the features',
  // each in table order
  for (int i = threadIdx.x; i < d.D; i += kThreads) {
    float from_slo = 0.f, from_features = 0.f;
    for (int q = 0; q < d.Q; ++q)
      if (smi[L.kind + q] == 0 && smi[L.pidx + q] == i)
        from_slo += sm[L.q + q];
    for (int j = 0; j < d.R * d.F; ++j)
      if (smi[L.rel + j] == i) from_features += sm[L.dx + j];
    dA[(size_t)k * d.D + i] = from_slo + from_features;
  }
}

__global__ void empty_kernel() {}

template <typename Kernel>
int prepare(Kernel kernel, const Dims& d, bool backward, size_t* smem) {
  if (d.K <= 0 || d.D <= 0 || d.R <= 0 || d.F <= 0 || d.F > kMaxF ||
      d.T <= 0 || d.Q <= 0 || d.S <= 0)
    return (int)cudaErrorInvalidValue;
  *smem = (size_t)make_layout(d, backward).total * 4;
  if (*smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
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
  size_t smem = 0;
  int err = prepare(rask_forward_kernel, d, false, &smem);
  if (err) return err;
  rask_forward_kernel<<<K, kThreads, smem, static_cast<cudaStream_t>(
                                                stream)>>>(A, t, out, d);
  return (int)cudaGetLastError();
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
  size_t smem = 0;
  int err = prepare(rask_backward_kernel, d, true, &smem);
  if (err) return err;
  rask_backward_kernel<<<K, kThreads, smem, static_cast<cudaStream_t>(
                                                 stream)>>>(A, ct, t, dA, d);
  return (int)cudaGetLastError();
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
