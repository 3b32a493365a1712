// Fused SDDMM → edge-softmax statistics for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel src/repro/kernels/sddmm/kernel.py::
// sddmm_softmax_kernel (body _fused_kernel).  For every slot (c, v, k) of
// the covered PCSR steering, with row = trow[c]·R + lrow[c·K+k]·V + v:
//   x     = LeakyReLU(scale · Q[row] · Kmat[colidx[c·K+k]])
//   logit = x where the stored vals[c,v,k] ≠ 0, else −inf
// and for every output row the softmax stats rowmax = max logit and
// rowsum = Σ exp(logit − rowmax) over the row's real edges (−inf and 0 for
// a row without one).  These are the operands of the ParamSpMM softmax
// prologue (paramspmm.cu), so α is never written to device memory.
//
// What bounds it.  Per real slot the kernel gathers one row of Kmat and V
// rows of Q (d·4 bytes each, mostly L2 hits) and writes one logit; per row
// it writes two floats.  The 2·nnz·d MACs are far below the float32 peak,
// so the floor is the steering, logits and stats traffic over HBM.  The
// first design (one thread block per chunk group, one slot per warp at a
// time) was latency-bound: a dependent chain per slot, and a power-law
// graph's hub group walked by one block.
//
// Design.  The grid is (work units, heads) over the host-built unit table
// of kernels/paramspmm/ops.py::work_units, shared with paramspmm.cu: a
// unit is a contiguous slot range of at most `cap` real slots inside one
// chunk group.  Logits are per slot, so units never collide on them.  A
// group that is one unit writes its rows' stats directly; each unit of a
// split group writes per-row partial (max, Σexp) pairs into a workspace,
// and sddmm_softmax_merge_kernel combines a group's partials in unit order
// with the flash rescale.  Padding units (begin = end) and padding splits
// (no partials) of a serving bucket's fixed tables return at once and
// write nothing.  Inside a unit the steering is staged in shared
// memory 256 slots at a time with cp.async, double-buffered.  LS lanes
// cover one d-wide dot with VW-wide loads (at d = 64: 16 lanes of float4,
// so a warp reduces two slots per step), each lane group keeps kUnroll
// slots' loads in flight, and a xor-shuffle tree inside the lane group
// gives the dot.  Each lane group folds its logits into its own online
// (max, Σexp) for the block's R ≤ 32 rows in shared memory (with the
// guards of sddmm/kernel.py:103-108: a non-finite max leaves the sum as it
// is, one exp per slot); at the unit's end the lane groups' pairs are
// merged in lane-group order.  Every merge runs in a fixed order, so the
// result does not depend on scheduling, and no atomics are used.
// Q rows ≥ n_rows (block padding) read as zero and are never loaded.
// Rounding: scale is a host-computed float multiplied in (__fmul_rn) and
// slope·x is __fmul_rn, so integer-valued operands give logits bit-equal
// to the plain version's.  Stats are indexed by the explicit block count
// (h·n_blocks·R + row), not by the grid.
//
// What is left: Q and Kmat are float32 (bf16 would halve the gathered
// bytes), and each gathered Kmat row comes through L2 once per slot.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "steering.h"

namespace {

constexpr int kThreads = 128;
constexpr int kStage = 256;        // staged slots per tile
constexpr int kUnroll = 2;         // slots in flight per lane group
constexpr int kMaxR = 32;
constexpr int kMinLanes = 4;       // lanes per slot at least (≤ 32 groups)
constexpr int kMergeBatch = 8;     // partial loads in flight per row

// The type of the running Σexp and of its exps: float32, as the TPU kernel
// keeps it.  A float64 Σexp agreed with the plain version's float64 sum
// more closely but took 2.1× the time on kreg150k (chip_compare.py
// sddmm-sum, PERF.md); -DREPRO_SDDMM_SUM=double builds that variant, and
// only that comparison builds it.  Split groups' partial sums are kept in
// the same type; the wrapper sizes their workspace by
// repro_sddmm_sum_bytes().
#ifndef REPRO_SDDMM_SUM
#define REPRO_SDDMM_SUM float
#endif
using Sum = REPRO_SDDMM_SUM;

// expf for a float sum (not __expf), exp for a double one
__device__ __forceinline__ float sum_exp(float x) { return expf(x); }
__device__ __forceinline__ double sum_exp(double x) { return exp(x); }

// Fold one logit x into a running (max, Σexp) pair with the guards of
// sddmm/kernel.py:103-108: a non-finite max leaves the sum as it is.  One
// exp per call: exp(0) = 1 is the other factor, whichever side x falls.
__device__ __forceinline__ void online_add(float* m, Sum* s, float x) {
  const float m_old = *m;
  const float m_new = fmaxf(m_old, x);
  *m = m_new;
  if (!isfinite(m_new)) return;
  if (x > m_old) {
    *s = *s * sum_exp(static_cast<Sum>(m_old) - m_new) + Sum(1);
  } else {
    *s += sum_exp(static_cast<Sum>(x) - m_new);
  }
}

template <int VW> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<1> { using T = float; };

__device__ __forceinline__ float dot(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float dot(float2 a, float2 b) {
  return a.x * b.x + a.y * b.y;
}
__device__ __forceinline__ float dot(float a, float b) { return a * b; }

template <int V, int VW>
__global__ void __launch_bounds__(kThreads)
sddmm_softmax_kernel(const int* __restrict__ colidx,
                     const int* __restrict__ lrow,
                     const int* __restrict__ trow,
                     const float* __restrict__ vals,
                     const int4* __restrict__ units, int n_chunks,
                     int n_blocks, int n_partials,
                     const float* __restrict__ Q, int n_rows,
                     const float* __restrict__ Kmat, int k_rows, int d,
                     int R, int K, int ls_log2, float scale, float slope,
                     float* __restrict__ logits, float* __restrict__ rowmax,
                     float* __restrict__ rowsum,
                     float* __restrict__ part_max,
                     Sum* __restrict__ part_sum) {
  using Vec = typename VecOf<VW>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LS = 1 << ls_log2;
  const int n_lg = kThreads >> ls_log2;
  const int tid = threadIdx.x;
  const int sl = tid & (LS - 1);
  const int lg = tid >> ls_log2;                   // lane group
  Sum* s_sum = reinterpret_cast<Sum*>(smem_raw);     // [n_lg][R]
  float* s_max = reinterpret_cast<float*>(s_sum + n_lg * R);
  int* st_col = reinterpret_cast<int*>(s_max + n_lg * R);  // [2][kStage]
  int* st_row = st_col + 2 * kStage;
  float* st_val =                                     // [2][V][kStage]
      reinterpret_cast<float*>(st_row + 2 * kStage);

  const int4 u = units[blockIdx.x];
  if (u.x >= u.y) return;       // a padding unit of a bucket's fixed grid
  const long long h = blockIdx.y;
  const long long row0 = static_cast<long long>(__ldg(trow + u.x / K)) * R;
  Q += h * n_rows * d;
  Kmat += h * k_rows * d;
  logits += h * n_chunks * V * K;
  for (int e = tid; e < n_lg * R; e += kThreads) {
    s_max[e] = -CUDART_INF_F;
    s_sum[e] = Sum(0);
  }

  const int nvec = d / VW;
  const int n_tiles = (u.y - u.x + kStage - 1) / kStage;
  auto stage = [&](int t) {
    const int buf = t & 1;
    const int base = u.x + t * kStage;
    const int n = min(kStage, u.y - base);
    for (int i = tid; i < n; i += kThreads) {
      const int slot = base + i;
      const int c = slot / K;
      const long long vk = static_cast<long long>(c) * V * K + (slot - c * K);
      __pipeline_memcpy_async(st_col + buf * kStage + i, colidx + slot, 4);
      __pipeline_memcpy_async(st_row + buf * kStage + i, lrow + slot, 4);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        __pipeline_memcpy_async(st_val + (buf * V + v) * kStage + i,
                                vals + vk + v * K, 4);
      }
    }
    __pipeline_commit();
  };

  if (n_tiles > 0) stage(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int buf = t & 1;
    const int base = u.x + t * kStage;
    const int n = min(kStage, u.y - base);
    const int* sc = st_col + buf * kStage;
    const int* sr = st_row + buf * kStage;
    const float* sv = st_val + buf * V * kStage;
    // one trip count for every lane of the block: the shuffles below need
    // each lane group of a warp to reach them together
    for (int i0 = 0; i0 < n; i0 += n_lg * kUnroll) {
      bool real[kUnroll][V];
      const float* qrow[kUnroll][V];
      const float* krow[kUnroll];
      float acc[kUnroll][V];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = i0 + k * n_lg + lg;
        krow[k] = nullptr;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          real[k][v] = i < n && sv[v * kStage + i] != 0.f;
          qrow[k][v] = nullptr;
          acc[k][v] = 0.f;
        }
        if (i >= n) continue;
        const long long r0 = row0 + sr[i] * V;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (real[k][v] && r0 + v < n_rows) {
            qrow[k][v] = Q + (r0 + v) * d;
            krow[k] = Kmat + static_cast<long long>(sc[i]) * d;
          }
        }
      }
      for (int j = sl; j < nvec; j += LS) {
        Vec kv[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (krow[k]) {
            kv[k] = __ldg(reinterpret_cast<const Vec*>(krow[k]) + j);
          }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if (qrow[k][v]) {
              acc[k][v] += dot(
                  __ldg(reinterpret_cast<const Vec*>(qrow[k][v]) + j), kv[k]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          for (int off = LS >> 1; off > 0; off >>= 1) {
            acc[k][v] += __shfl_xor_sync(0xffffffffu, acc[k][v], off);
          }
        }
      }
      if (sl == 0) {
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int i = i0 + k * n_lg + lg;
          if (i >= n) continue;
          const int r0 = sr[i] * V;
          float* lp = logits + static_cast<long long>(base + i) / K * V * K
                      + (base + i) % K;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if (!real[k][v]) {
              lp[v * K] = -CUDART_INF_F;
              continue;
            }
            float x = __fmul_rn(acc[k][v], scale);
            x = x >= 0.f ? x : __fmul_rn(slope, x);  // LeakyReLU
            lp[v * K] = x;
            online_add(s_max + lg * R + r0 + v, s_sum + lg * R + r0 + v, x);
          }
        }
      }
    }
    __syncthreads();
  }
  if (n_tiles == 0) __syncthreads();

  if (tid < R) {                       // merge lane groups, in order
    const int r = tid;
    float m = -CUDART_INF_F;
    for (int g = 0; g < n_lg; ++g) m = fmaxf(m, s_max[g * R + r]);
    Sum sum = 0;
    if (isfinite(m)) {
      for (int g = 0; g < n_lg; ++g) {
        sum += s_sum[g * R + r] *
               sum_exp(static_cast<Sum>(s_max[g * R + r]) - m);
      }
    }
    if (u.w >= 0) {
      const long long at = (h * n_partials + u.w) * R + r;
      part_max[at] = m;
      part_sum[at] = sum;
    } else {
      const long long at = h * n_blocks * R + row0 + r;
      rowmax[at] = m;
      rowsum[at] = static_cast<float>(sum);
    }
  }
}

// One warp per (split group, head), a thread per row: the group's partial
// (max, Σexp) pairs merged in unit order with the flash rescale and the
// same guards, kMergeBatch pairs' loads in flight at a time.
__global__ void __launch_bounds__(32)
sddmm_softmax_merge_kernel(const int* __restrict__ splits,
                           const float* __restrict__ part_max,
                           const Sum* __restrict__ part_sum,
                           int n_partials, int n_blocks, int R,
                           float* __restrict__ rowmax,
                           float* __restrict__ rowsum) {
  const int r = threadIdx.x;
  if (r >= R) return;
  const long long row0 = static_cast<long long>(splits[3 * blockIdx.x]) * R;
  const int p0 = splits[3 * blockIdx.x + 1];
  const int p1 = splits[3 * blockIdx.x + 2];
  if (p1 <= p0) return;         // a padding split: no partials, no block
  const long long h = blockIdx.y;
  const float* pm = part_max + (h * n_partials + p0) * R + r;
  const Sum* ps = part_sum + (h * n_partials + p0) * R + r;
  const int np = p1 - p0;
  float m = -CUDART_INF_F;
  for (int q = 0; q < np; q += kMergeBatch) {
#pragma unroll
    for (int k = 0; k < kMergeBatch; ++k) {
      if (q + k < np) m = fmaxf(m, pm[static_cast<long long>(q + k) * R]);
    }
  }
  Sum sum = 0;
  if (isfinite(m)) {
    for (int q = 0; q < np; q += kMergeBatch) {   // in unit order
      float mq[kMergeBatch];
      Sum sq[kMergeBatch];
#pragma unroll
      for (int k = 0; k < kMergeBatch; ++k) {
        const long long at = static_cast<long long>(q + k < np ? q + k : 0) *
                             R;
        mq[k] = pm[at];
        sq[k] = ps[at];
      }
#pragma unroll
      for (int k = 0; k < kMergeBatch; ++k) {
        if (q + k < np) {
          sum += sq[k] * sum_exp(static_cast<Sum>(mq[k]) - m);
        }
      }
    }
  }
  const long long at = h * n_blocks * R + row0 + r;
  rowmax[at] = m;
  rowsum[at] = static_cast<float>(sum);
}

template <int V, int VW>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const int* colidx, const int* lrow, const int* trow,
                   const float* vals, const int4* units, int n_chunks,
                   int n_blocks, int n_partials, const float* Q, int n_rows,
                   const float* Kmat, int k_rows, int d, int R, int K,
                   int ls_log2, float scale, float slope, float* logits,
                   float* rowmax, float* rowsum, float* part_max,
                   Sum* part_sum) {
  // smem ≤ 32·32·12 + 2·256·4·4 bytes (n_lg ≤ 32, R ≤ 32, V ≤ 2): under
  // the 48 KB a launch gets without opting in
  sddmm_softmax_kernel<V, VW><<<grid, kThreads, smem, stream>>>(
      colidx, lrow, trow, vals, units, n_chunks, n_blocks, n_partials, Q,
      n_rows, Kmat, k_rows, d, R, K, ls_log2, scale, slope, logits, rowmax,
      rowsum, part_max, part_sum);
  return cudaGetLastError();
}

template <int V>
auto pick(int vw) {
  return vw == 4 ? launch<V, 4> : vw == 2 ? launch<V, 2> : launch<V, 1>;
}

}  // namespace

extern "C" {

// Launch on `stream`: the unit kernel over n_units × H thread blocks, then,
// when some group is split (n_splits > 0), the merge over n_splits × H.
// Q is (H, n_rows, d), Kmat (H, k_rows, d), logits (H, n_chunks, V, K),
// rowmax/rowsum (H, n_blocks·R), part_max (H, n_partials, R) float32 and
// part_sum (H, n_partials, R) of the Σexp type (repro_sddmm_sum_bytes()
// bytes each), all contiguous.  vw ∈ {1, 2, 4} is
// the load width (d and the addresses of Q and Kmat must allow it).
// Returns the cudaError_t of the launches (0 = success).
int repro_sddmm_softmax_f32(const SteeringArgs* st, void* part_max,
                            void* part_sum, const void* Q, int n_rows,
                            const void* Kmat, int k_rows, int d, int H,
                            int V, int R, int K, int vw, float scale,
                            float slope, void* logits, void* rowmax,
                            void* rowsum, void* stream) {
  if (st->n_units <= 0 || H <= 0) return 0;
  if ((V != 1 && V != 2) || R < 1 || R > kMaxR || K < 1 || d < 0 ||
      H > 65535 || (vw != 1 && vw != 2 && vw != 4) || d % vw != 0 ||
      (st->n_splits > 0 && (part_max == nullptr || part_sum == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nvec = d / vw;
  int ls = kMinLanes;
  while (ls < nvec && ls < 32) ls *= 2;
  const int ls_log2 = __builtin_ctz(ls);
  const int n_lg = kThreads / ls;
  const size_t smem = static_cast<size_t>(n_lg) * R *
                          (sizeof(Sum) + sizeof(float)) +
                      2 * kStage * (2 + V) * 4;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  auto go = V == 1 ? pick<1>(vw) : pick<2>(vw);
  dim3 grid(static_cast<unsigned>(st->n_units), static_cast<unsigned>(H));
  cudaError_t e = go(
      grid, smem, cs, st->colidx, st->lrow, st->trow, st->vals, st->units,
      st->n_chunks, st->n_blocks, st->n_partials,
      static_cast<const float*>(Q), n_rows, static_cast<const float*>(Kmat),
      k_rows, d, R, K, ls_log2, scale, slope, static_cast<float*>(logits),
      static_cast<float*>(rowmax), static_cast<float*>(rowsum),
      static_cast<float*>(part_max), static_cast<Sum*>(part_sum));
  if (e != cudaSuccess || st->n_splits == 0) return static_cast<int>(e);
  dim3 mgrid(static_cast<unsigned>(st->n_splits), static_cast<unsigned>(H));
  sddmm_softmax_merge_kernel<<<mgrid, 32, 0, cs>>>(
      st->splits, static_cast<const float*>(part_max),
      static_cast<const Sum*>(part_sum), st->n_partials, st->n_blocks, R,
      static_cast<float*>(rowmax), static_cast<float*>(rowsum));
  return static_cast<int>(cudaGetLastError());
}

int repro_sddmm_sum_bytes() { return static_cast<int>(sizeof(Sum)); }

int repro_steering_args_size() {
  return static_cast<int>(sizeof(SteeringArgs));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
