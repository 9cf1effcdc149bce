// Decode attention: one new token per row attends, with grouped-query
// heads, to the slots [start[b], length[b]) of a (B, S, KH, D) KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// ::decode_attention_pallas (body _da_kernel). That kernel walks the whole
// sequence on a grid (B, KH, S/512), in order, carrying an online softmax
// in VMEM scratch, and streams even the blocks outside [start, length).
//
// What bounds it on the H100: bytes, and at the serving path's sizes the
// latency of fetching them. Each (row, kv head) reads its K and V ranges
// once and does 4*G flops per element read (G = 4 query heads at
// gemma3-1b), far below the ~295 flops/byte the card needs to be compute
// bound. The batched engine gives only B*KH = 4 (row, kv head) pairs of
// at most ~1000 slots (1 MB of K and V in bf16): one CTA a pair would
// fetch at one SM's rate and leave 128 SMs idle, and a second kernel that
// combines split partials costs a launch and a round trip of them through
// device memory.
//
// What the design does about it (flash-decoding inside a cluster, one
// launch):
//  * One thread-block cluster of `cluster` CTAs per (row, kv head); the
//    wrapper picks the largest power of two up to 16 whose grid fits one
//    wave of the card's SMs (16 at gemma3-1b's 4 slots). The row's range
//    [start, length) is cut into `cluster` contiguous shares, one a CTA,
//    so only the range is read and the grid does not grow with S.
//  * A CTA streams its share through a ring of shared-memory stages of 32
//    slots (4 stages in bf16, 3 in float32: shared memory does not grow
//    with S). Every thread issues 16-byte cp.async copies of its part of a
//    stage and arrives on the stage's mbarrier when they land
//    (cp.async.mbarrier.arrive), so the stages ahead are in flight while
//    the CTA computes; the q loads and the range's own loads overlap them.
//    Rows land 16 bytes further apart than their length, so that 32 lanes
//    reading 32 rows hit 32 distinct banks. Rows that are not 16-byte
//    multiples, or caches not 16-byte aligned, are copied with plain loads.
//    (One bulk copy a row through the copy engine measured slower on the
//    H100.)
//  * Products, in bf16 with D % 16 == 0 (the serving path): q K^T and P V
//    on the tensor cores, mma.sync m16n8k16 with the G heads padded to 16
//    rows and float32 accumulation; the 8 warps split D (q K^T: 16-column
//    k-steps, partial scores summed in warp order; P V: 32 columns each).
//    P is rounded to bf16 for P V, as the plain version rounds it. The
//    point is fewer instructions, not flops: a CTA runs its loop once or
//    twice, so its time is the instructions it issues and fetches.
//    Otherwise (float32, other D) on the CUDA cores: a lane owns a slot
//    and walks D with q (pre-scaled) broadcast from shared memory, the
//    warps taking every 8th 16-byte chunk of D; a thread per element of D
//    accumulates P V for all G heads. No shuffle chain per slot either way.
//  * An online softmax per query head across the stages, a warp a head and
//    a lane a slot, in float32.
//  * The combine stays on chip: each CTA stores its unnormalised partial
//    (running max m, denominator l, and o for each slice of D) straight
//    into the shared memory of the CTA that combines that slice
//    (distributed shared memory), then one cluster barrier publishes the
//    stores. Each CTA then weighs the cluster's partials of its slice,
//    exp(m_r - M) / max(sum_r l_r exp(m_r - M), 1e-30), summed in rank
//    order. No atomics, no scratch in device memory, a fixed order: two
//    calls give the same bits.
//  * Small code: a CTA runs its loops once or twice, and every instruction
//    it runs for the first time is fetched from L2, so the kernel is
//    instantiated per G (1..8) and the cold loops stay rolled.
//  * Lengths and starts are per row, device-resident int32 vectors: the
//    engine decodes every slot in one launch, each slot at its own length.
//    A row whose range is empty (only an idle engine lane, whose output
//    nobody reads) gets zeros, where the plain version averages V over the
//    whole cache.
// Scores, the softmax and the accumulators are float32; P enters the
// tensor cores' P V in bf16.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {
namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32;     // cache slots of a ring stage: a lane each
constexpr int kMaxD = 256;     // a thread holds one element of D in P V
constexpr int kMaxG = 8;       // query heads per kv head
constexpr int kMaxCluster = 16;
static_assert(kMaxG <= kWarps, "the online softmax takes a warp a head");

template <typename T>
__host__ __device__ constexpr int ring_stages() {
  return sizeof(T) == 2 ? 4 : 3;
}

// Shared-memory layout in bytes: mbarriers, the ring (K then V rows of
// each stage), q, the warps' partial scores, probabilities and rescale
// factors, then what the cluster's CTAs send this one to combine: every
// CTA's (m, l) and its partial o over this CTA's share of the outputs.
struct Layout {
  int row, ring, q, part, p, pb, alpha, in_ml, in_o, total;
};

constexpr int kPbRow = 40;  // bf16 a row of the tensor-core P tile (80 bytes)

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// elements of D whose G outputs a CTA of an n_cta cluster combines: a
// multiple of 8, so that an 8-column tile of the tensor-core path has one
// owner
__host__ __device__ inline int share_of(int D, int n_cta) {
  return round_up((D + n_cta - 1) / n_cta, 8);
}

__host__ __device__ inline Layout make_layout(int G, int D, int es,
                                              int stages, int n_cta) {
  Layout L;
  L.row = round_up(D * es, 16) + 16;
  L.ring = 128;
  L.q = L.ring + stages * 2 * kSlots * L.row;
  L.part = L.q + G * round_up(D, 8) * 4;
  L.p = L.part + kWarps * G * kSlots * 4;
  L.pb = L.p + kSlots * kMaxG * 4;
  L.alpha = L.pb + kMaxG * kPbRow * 2;
  L.in_ml = L.alpha + kMaxG * 4;
  L.in_o = L.in_ml + n_cta * 2 * kMaxG * 4;
  L.total = L.in_o + n_cta * G * share_of(D, n_cta) * 4;
  return L;
}

// x / d for x >= 0 and d > 0, a shift when d is a power of two (the usual
// case: cluster sizes, chunks of a row, shares of D): an integer division
// costs about as much as a shared-memory round trip, on the critical path.
struct Divisor {
  int d, shift;
  bool pow2;
  __device__ int div(int x) const { return pow2 ? x >> shift : x / d; }
};

__device__ __forceinline__ Divisor divisor(int d) {
  return {d, __ffs(d) - 1, (d & (d - 1)) == 0};
}

// One instantiation per dtype, per G = H / KH (query heads a kv head,
// 1..8) and per product unit: the per-head loops unroll exactly, which
// keeps the code a CTA runs once or twice short (it is fetched from L2 as
// it runs). kMma (bf16, D % 16 == 0) computes q K^T and P V with
// mma.sync m16n8k16, the G heads padded to 16 rows; otherwise CUDA-core
// FMA.
template <typename T, int G, bool kMma>
__global__ void __launch_bounds__(kThreads) decode_cluster_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ length, const int* __restrict__ start,
    T* __restrict__ out, int H, int KH, int S, int D, float scale,
    int vec) {
  constexpr int kStages = ring_stages<T>();
  constexpr int kVec = 16 / sizeof(T);  // elements of a 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int kh = blockIdx.y, b = blockIdx.z;
  const int Dq = round_up(D, 8);
  const Layout L = make_layout(G, D, sizeof(T), kStages, n_cta);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + L.ring;
  float* q_s = reinterpret_cast<float*>(smem + L.q);        // [G][Dq]
  float* part_s = reinterpret_cast<float*>(smem + L.part);  // [warp][G][slot]
  float* p_s = reinterpret_cast<float*>(smem + L.p);        // [slot][kMaxG]
  __nv_bfloat16* p_bf =                                     // [g][kPbRow]
      reinterpret_cast<__nv_bfloat16*>(smem + L.pb);
  float* alpha_s = reinterpret_cast<float*>(smem + L.alpha);
  float* in_ml = reinterpret_cast<float*>(smem + L.in_ml);  // [rank][m, l]
  float* in_o = reinterpret_cast<float*>(smem + L.in_o);    // [rank][G][share]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // announce this CTA has started (waited for before the first remote
  // store: a CTA's shared memory takes stores once it runs)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // q, loaded alongside the range: element tid of each head, scaled (FMA),
  // or this warp's 16-column k-steps warp, warp + 8 as mma A fragments
  // (rows lane / 4 < G; the padding rows are zero)
  const T* q_row = q + ((size_t)b * H + (size_t)kh * G) * D;
  float q_reg[G];
  uint32_t qa[2][4] = {};
  if constexpr (kMma) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ks = warp + kWarps * i;
      if (ks * 16 < D && lane / 4 < G) {
        const T* qr = q_row + (lane / 4) * D + ks * 16 + (lane % 4) * 2;
        qa[i][0] = *reinterpret_cast<const uint32_t*>(qr);
        qa[i][2] = *reinterpret_cast<const uint32_t*>(qr + 8);
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g)
      q_reg[g] = tid < D ? to_float(q_row[g * D + tid]) * scale : 0.f;
  }

  // this CTA's share of the row's range
  const int end = min(length[b], S);
  const int begin = max(start[b], 0);
  const int n = max(end - begin, 0);
  const Divisor by_cta = divisor(n_cta);
  const int per = by_cta.div(n + n_cta - 1);
  const int lo = begin + rank * per;
  const int mine = max(min(lo + per, end) - lo, 0);
  const int n_stages = (mine + kSlots - 1) / kSlots;

  __syncthreads();  // the barriers are initialised

  const size_t pos_stride = (size_t)KH * D;
  const T* k_base = k + ((size_t)b * S * KH + kh) * D;
  const T* v_base = v + ((size_t)b * S * KH + kh) * D;

  // a thread's place in a stage's copy: rows fill_j, fill_j + fill_rows,
  // ..., at 16-byte chunk fill_c (element fill_c in the unaligned case);
  // the divisions are made once
  const int chunks = vec ? D / kVec : D;
  const Divisor by_chunks = divisor(chunks);
  const int fill_rows = by_chunks.div(kThreads);
  const int fill_j = by_chunks.div(tid), fill_c = tid - fill_j * chunks;

  // every thread: issue its share of stage s's copies into the stage's
  // ring buffer, then arrive on the stage's barrier once they land
  auto fill = [&](int s) {
    const int buf = s % kStages, j0 = lo + s * kSlots;
    const int rows = min(kSlots, mine - s * kSlots);
    unsigned char* ks = ring + (size_t)buf * 2 * kSlots * L.row;
    unsigned char* vs = ks + (size_t)kSlots * L.row;
    if (vec) {
#pragma unroll 1
      for (int j = fill_j; j < rows && fill_j < fill_rows; j += fill_rows) {
        const size_t off = (size_t)(j0 + j) * pos_stride + fill_c * kVec;
        cp_async16(ks + j * L.row + fill_c * 16, k_base + off);
        cp_async16(vs + j * L.row + fill_c * 16, v_base + off);
      }
      cp_async_arrive(&full[buf]);
    } else {
#pragma unroll 1
      for (int j = fill_j; j < rows && fill_j < fill_rows; j += fill_rows) {
        const size_t off = (size_t)(j0 + j) * pos_stride + fill_c;
        reinterpret_cast<T*>(ks + j * L.row)[fill_c] = k_base[off];
        reinterpret_cast<T*>(vs + j * L.row)[fill_c] = v_base[off];
      }
      mbar_arrive(&full[buf]);
    }
  };
#pragma unroll 1
  for (int s = 0; s < min(kStages, n_stages); ++s) fill(s);

  if constexpr (!kMma) {
    if (tid < Dq) {
#pragma unroll
      for (int g = 0; g < G; ++g) q_s[g * Dq + tid] = q_reg[g];
    }
  }
  __syncthreads();

  float m_run = kNegInf, l_run = 0.f;  // head `warp`'s, in its lanes
  // P V accumulators: FMA, element tid of D for every head; mma, the C
  // fragments of this warp's 4 column tiles (row lane / 4, columns
  // 32 warp + 8 nt + 2 (lane % 4) and + 1)
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  float acc_t[4][4] = {};

  for (int s = 0; s < n_stages; ++s) {
    const int buf = s % kStages;
    const int rows = min(kSlots, mine - s * kSlots);
    const unsigned char* ks = ring + (size_t)buf * 2 * kSlots * L.row;
    const unsigned char* vs = ks + (size_t)kSlots * L.row;
    mbar_wait(&full[buf], (s / kStages) & 1);

    if constexpr (kMma) {
      // scores on the tensor cores: S (heads x 32 slots) = q K^T over this
      // warp's k-steps, 4 tiles of 8 slots; B fragments straight from the
      // padded K rows (conflict-free 4-byte loads)
      float sc[4][4] = {};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kstep = warp + kWarps * i;
        if (kstep * 16 < D) {
          const unsigned char* kc = ks + (kstep * 16 + (lane % 4) * 2) * 2;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t* row = reinterpret_cast<const uint32_t*>(
                kc + (nt * 8 + lane / 4) * L.row);
            const uint32_t bk[2] = {row[0], row[4]};  // + 8 elements
            mma_bf16(sc[nt], qa[i], bk);
          }
        }
      }
      if (lane / 4 < G) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<float2*>(
              part_s + (warp * G + lane / 4) * kSlots + nt * 8 +
              (lane % 4) * 2) = make_float2(sc[nt][0], sc[nt][1]);
      }
    } else if (lane < rows) {
      // scores: lane = slot, this warp's 16-byte chunks of D
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      const T* k_row = reinterpret_cast<const T*>(ks + lane * L.row);
      for (int c = warp; c * kVec < D; c += kWarps) {
        float kf[kVec];
        if ((c + 1) * kVec <= D) {
          const uint4 raw = reinterpret_cast<const uint4*>(k_row)[c];
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int i = 0; i < kVec; ++i) kf[i] = to_float(e[i]);
        } else {  // the ragged end of D: the row's padding is not data
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            kf[i] = c * kVec + i < D ? to_float(k_row[c * kVec + i]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float4* qv =
                reinterpret_cast<const float4*>(q_s + g * Dq + c * kVec);
#pragma unroll
            for (int i = 0; i < kVec / 4; ++i) {
              const float4 x = qv[i];
              part[g] += x.x * kf[4 * i] + x.y * kf[4 * i + 1] +
                         x.z * kf[4 * i + 2] + x.w * kf[4 * i + 3];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) part_s[(warp * G + g) * kSlots + lane] = part[g];
    }
    __syncthreads();
    // the buffer consumed last stage is free: refill it kStages ahead
    if (s >= 1 && s - 1 + kStages < n_stages) fill(s - 1 + kStages);

    // online softmax, a warp per query head, a lane per slot (the mma
    // path's q is not pre-scaled: its scores take the scale here)
    if (warp < G) {
      const int g = warp;
      float sc = kNegInf;
      if (lane < rows) {
        sc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          sc += part_s[(w * G + g) * kSlots + lane];
        if constexpr (kMma) sc *= scale;
      }
      const float m_new = fmaxf(m_run, warp_max(sc));
      const float p = lane < rows ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + warp_sum(p);
      m_run = m_new;
      if constexpr (kMma)
        p_bf[g * kPbRow + lane] = __float2bfloat16(p);
      else
        p_s[lane * kMaxG + g] = p;
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();

    if constexpr (kMma) {
      // P V on the tensor cores: O (heads x D) += P (heads x 32 slots) V,
      // this warp's 32 columns of D as 4 tiles, two k-steps of 16 slots;
      // V by transposing ldmatrix, its rows past the stage's end zeroed
      // (they hold an earlier stage's data or nothing)
      const int g = lane / 4;
      if (g < G) {
        const float alpha = alpha_s[g];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc_t[nt][0] *= alpha;
          acc_t[nt][1] *= alpha;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (kk * 16 < rows) {
          uint32_t pa[4] = {};
          if (g < G) {
            const __nv_bfloat16* pr = p_bf + g * kPbRow + kk * 16 +
                                      (lane % 4) * 2;
            pa[0] = *reinterpret_cast<const uint32_t*>(pr);
            pa[2] = *reinterpret_cast<const uint32_t*>(pr + 8);
          }
          // which of this lane's 4 bf16 of V are past the stage's end
          const int k0 = kk * 16 + (lane % 4) * 2;
          const uint32_t keep0 = (k0 < rows ? 0xffffu : 0u) |
                                 (k0 + 1 < rows ? 0xffff0000u : 0u);
          const uint32_t keep1 = (k0 + 8 < rows ? 0xffffu : 0u) |
                                 (k0 + 9 < rows ? 0xffff0000u : 0u);
#pragma unroll
          for (int nt = 0; nt < 4; nt += 2) {
            const int n0 = warp * 32 + nt * 8;
            if (n0 < D) {
              uint32_t vb[4];
              ldsm_x4_t(vb, vs + (kk * 16 + lane % 16) * L.row +
                                (n0 + 8 * (lane / 16)) * 2);
              const uint32_t b0[2] = {vb[0] & keep0, vb[1] & keep1};
              const uint32_t b1[2] = {vb[2] & keep0, vb[3] & keep1};
              mma_bf16(acc_t[nt], pa, b0);
              mma_bf16(acc_t[nt + 1], pa, b1);
            }
          }
        }
      }
    } else if (tid < D) {
      // P V: a thread per element of D, all G heads at once
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= alpha_s[g];
      for (int j = 0; j < rows; ++j) {
        const float vv =
            to_float(reinterpret_cast<const T*>(vs + j * L.row)[tid]);
        const float4 p0 = reinterpret_cast<const float4*>(p_s + j * kMaxG)[0];
        acc[0] += p0.x * vv;
        acc[1] += p0.y * vv;
        acc[2] += p0.z * vv;
        acc[3] += p0.w * vv;
        if (G > 4) {
          const float4 p1 =
              reinterpret_cast<const float4*>(p_s + j * kMaxG)[1];
          acc[4] += p1.x * vv;
          acc[5] += p1.y * vv;
          acc[6] += p1.z * vv;
          acc[7] += p1.w * vv;
        }
      }
    }
  }

  // send this CTA's partial to the CTAs that combine it: (m, l) to every
  // CTA, the G outputs of element d of D to the CTA whose share of D holds
  // it (remote stores into distributed shared memory; the cluster barrier
  // publishes them)
  const int share = round_up(by_cta.div(D + n_cta - 1), 8);  // share_of
  const Divisor by_share = divisor(share);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if constexpr (kMma) {
    const int g = lane / 4;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n0 = warp * 32 + nt * 8;  // a tile has one owner
      if (g < G && n0 < D) {
        const int c = by_share.div(n0), dl = n0 - c * share + (lane % 4) * 2;
        float* to = cluster.map_shared_rank(in_o, c) +
                    (rank * G + g) * share + dl;
        *reinterpret_cast<float2*>(to) =
            make_float2(acc_t[nt][0], acc_t[nt][1]);
      }
    }
  } else if (tid < D) {
    const int c = by_share.div(tid), dl = tid - c * share;
    float* to = cluster.map_shared_rank(in_o, c) + rank * G * share + dl;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) to[g * share] = acc[g];
  }
  if (warp < G && lane < n_cta) {
    float* to = cluster.map_shared_rank(in_ml, lane) + rank * 2 * kMaxG;
    to[warp] = m_run;
    to[kMaxG + warp] = l_run;
  }
  cluster.sync();

  // each head's weights over the cluster, exp(m_r - M) / sum_r l_r
  // exp(m_r - M): a warp a head, a lane a rank (fixed shuffle trees)
  float* wn = part_s;  // [G][kMaxCluster]; the partial scores are done
  if (warp < G) {
    const float* ml = in_ml + lane * 2 * kMaxG;
    const float m_r = lane < n_cta ? ml[warp] : kNegInf;
    const float m_max = warp_max(m_r);  // every lane takes part
    const float w = lane < n_cta ? expf(m_r - m_max) : 0.f;
    const float denom = warp_sum(lane < n_cta ? ml[kMaxG + warp] * w : 0.f);
    if (lane < n_cta)
      wn[warp * kMaxCluster + lane] = w / fmaxf(denom, kMinDenom);
  }
  __syncthreads();

  // combine this CTA's share of D for all G heads from its own shared
  // memory, the partials in rank order
  T* o_row = out + ((size_t)b * H + (size_t)kh * G) * D;
#pragma unroll 1
  for (int i = tid; i < G * share; i += kThreads) {
    const int g = by_share.div(i), dl = i - g * share, d = rank * share + dl;
    if (d >= D) continue;
    float o = 0.f;
#pragma unroll 4
    for (int r = 0; r < n_cta; ++r)
      o += in_o[(r * G + g) * share + dl] * wn[g * kMaxCluster + r];
    store_as(o_row + g * D + d, o);
  }
}

// The dynamic shared-memory limit of an instantiation, raised once per
// device to the largest layout it takes (D = 256, a cluster of 16).
template <typename T, int G, bool kMma>
cudaError_t raise_smem_limit(int cluster) {
  static bool done[64] = {};
  static bool wide[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    const Layout L =
        make_layout(G, kMaxD, sizeof(T), ring_stages<T>(), kMaxCluster);
    err = cudaFuncSetAttribute(decode_cluster_kernel<T, G, kMma>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L.total);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  if (cluster > 8 && !wide[dev]) {
    err = cudaFuncSetAttribute(decode_cluster_kernel<T, G, kMma>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    wide[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, int G, bool kMma>
int launch(const void* q, const void* k, const void* v, const int* length,
           const int* start, void* out, int B, int H, int KH, int S, int D,
           int cluster, cudaStream_t stream) {
  cudaError_t err = raise_smem_limit<T, G, kMma>(cluster);
  if (err != cudaSuccess) return (int)err;
  const Layout L = make_layout(G, D, sizeof(T), ring_stages<T>(), cluster);
  const int vec = (D * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, KH, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_cluster_kernel<T, G, kMma>,
                           static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), length, start,
                           static_cast<T*>(out), H, KH, S, D,
                           rsqrtf((float)D), vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_by_g(const void* q, const void* k, const void* v,
                const int* length, const int* start, void* out, int B, int H,
                int KH, int S, int D, int cluster, cudaStream_t s) {
  // the tensor cores take bf16 rows of whole 16-element k-steps
  const bool mma = sizeof(T) == 2 && D % 16 == 0;
#define REPRO_DECODE_G(G_)                                                   \
  case G_:                                                                   \
    return mma ? launch<T, G_, sizeof(T) == 2>(q, k, v, length, start, out,  \
                                               B, H, KH, S, D, cluster, s)   \
               : launch<T, G_, false>(q, k, v, length, start, out, B, H, KH, \
                                      S, D, cluster, s);
  switch (H / KH) {
    REPRO_DECODE_G(1)
    REPRO_DECODE_G(2)
    REPRO_DECODE_G(3)
    REPRO_DECODE_G(4)
    REPRO_DECODE_G(5)
    REPRO_DECODE_G(6)
    REPRO_DECODE_G(7)
    REPRO_DECODE_G(8)
  }
#undef REPRO_DECODE_G
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/decode_attention.py.
// One launch: a cluster of `cluster` CTAs (1..16) per (row, kv head).
// Returns a cudaError_t code (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* length, const int* start,
                                void* out, int B, int H, int KH, int S, int D,
                                int cluster, int dtype, void* stream) {
  using namespace repro_torch;
  if (D <= 0 || D > kMaxD || KH <= 0 || H % KH != 0 || H / KH > kMaxG ||
      cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_by_g<float>(q, k, v, length, start, out, B, H, KH, S, D,
                              cluster, s);
  if (dtype == kBFloat16)
    return launch_by_g<__nv_bfloat16>(q, k, v, length, start, out, B, H, KH,
                                      S, D, cluster, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
