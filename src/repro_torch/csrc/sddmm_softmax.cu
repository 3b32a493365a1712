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
// Design.  The TPU kernel is race-free only because its (C, K, J) grid runs
// in order: the stats of a block split across chunks accumulate in VMEM
// across consecutive revisits.  Here one thread block owns one (chunk
// group, head): a chunk group is all chunks of one output block (the
// host-built table `groups`, as in paramspmm.cu), so no two thread blocks
// touch one row's stats and no atomics are needed.  Heads are grid axis y
// over the single-head steering (head h reads Q, Kmat and writes logits and
// stats at its own offsets).  Inside the block, warp w takes the group's
// slots w, w + kWarps, ...; its lanes split the feature dim and a shuffle
// reduction gives the dot (lane 0's sum is the one used).  A slot whose V
// values are all zero (padding, coverage and filler chunks) loads nothing
// and publishes −inf.  Each warp keeps its own online (max, Σexp) for the
// block's R ≤ 32 rows in shared memory (lane 0 updates them, with the
// guards of sddmm/kernel.py:103-108, one exp per slot); at the group's
// end the warps' partials are merged in warp order with the flash
// rescale, so the result does not depend on scheduling.
// Q rows ≥ n_rows (block padding) read as zero and are never loaded.
// Rounding: scale is a host-computed float multiplied in (__fmul_rn) and
// slope·x is __fmul_rn, so integer-valued operands give logits bit-equal
// to the plain version's.
//
// Bound on this card.  Per real slot the kernel gathers one row of Kmat
// and reads V rows of Q (d·4 bytes each); it writes one logit per slot and
// two floats per row.  Read once each, Q, Kmat, the steering and the
// outputs are the byte floor; the 2·nnz·d MACs are far below the float32
// peak.  Like paramspmm.cu it is latency-bound: each slot is a dependent
// chain (colidx → Kmat row → shuffle reduction), and a power-law graph's
// hub group is one thread block's serial walk.  A later change should
// split large groups across thread blocks with a second merge pass.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxR = 32;

// The type of the running Σexp and of its exps: float32, as the TPU kernel
// keeps it.  A float64 Σexp agreed with the plain version's float64 sum
// more closely but took 2.1× the time on kreg150k, where each block's
// serial float64 exps in the warp merge dominate (chip_compare.py
// sddmm-sum, PERF.md); -DREPRO_SDDMM_SUM=double builds that variant, and
// only that comparison builds it.
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

template <int V>
__global__ void __launch_bounds__(kThreads)
sddmm_softmax_kernel(const int* __restrict__ colidx,
                     const int* __restrict__ lrow,
                     const int* __restrict__ trow,
                     const float* __restrict__ vals,
                     const int* __restrict__ groups, int n_chunks,
                     const float* __restrict__ Q, int n_rows,
                     const float* __restrict__ Kmat, int k_rows, int d,
                     int R, int K, float scale, float slope,
                     float* __restrict__ logits, float* __restrict__ rowmax,
                     float* __restrict__ rowsum) {
  __shared__ float s_max[kWarps][kMaxR];
  __shared__ Sum s_sum[kWarps][kMaxR];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.y;
  if (lane < R) {
    s_max[warp][lane] = -CUDART_INF_F;
    s_sum[warp][lane] = Sum(0);
  }
  __syncthreads();          // lane 0 of each warp reads what its lanes wrote
  Q += static_cast<long long>(h) * n_rows * d;
  Kmat += static_cast<long long>(h) * k_rows * d;
  logits += static_cast<long long>(h) * n_chunks * V * K;

  const int c0 = groups[blockIdx.x];
  const int c1 = groups[blockIdx.x + 1];
  const long long row0 = static_cast<long long>(__ldg(trow + c0)) * R;
  const long long n_slots = static_cast<long long>(c1 - c0) * K;
  for (long long s = warp; s < n_slots; s += kWarps) {
    const long long slot = static_cast<long long>(c0) * K + s;
    const long long c = slot / K;
    const long long k = slot - c * K;
    const float* vc = vals + c * V * K + k;      // vals[c, v, k] at vc[v·K]
    float* lg = logits + c * V * K + k;
    bool real[V];
    bool any = false;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      real[v] = __ldg(vc + v * K) != 0.f;
      any = any || real[v];
    }
    if (!any) {                                  // padding slot
      if (lane < V) lg[lane * K] = -CUDART_INF_F;
      continue;
    }
    const int r0 = __ldg(lrow + slot) * V;       // block-local first row
    const float* krow = Kmat + static_cast<long long>(__ldg(colidx + slot)) * d;
    const float* qrow[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const long long row = row0 + r0 + v;
      qrow[v] = real[v] && row < n_rows ? Q + row * d : nullptr;
    }
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float kv = __ldg(krow + i);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (qrow[v]) acc[v] += __ldg(qrow[v] + i) * kv;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[v] += __shfl_down_sync(0xffffffffu, acc[v], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (!real[v]) {
          lg[v * K] = -CUDART_INF_F;
          continue;
        }
        float x = __fmul_rn(acc[v], scale);
        x = x >= 0.f ? x : __fmul_rn(slope, x);  // LeakyReLU
        lg[v * K] = x;
        online_add(&s_max[warp][r0 + v], &s_sum[warp][r0 + v], x);
      }
    }
  }

  __syncthreads();
  if (threadIdx.x < R) {                         // merge warps, in order
    const int r = threadIdx.x;
    float m = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, s_max[w][r]);
    Sum sum = 0;
    if (isfinite(m)) {
      for (int w = 0; w < kWarps; ++w) {
        sum += s_sum[w][r] * sum_exp(static_cast<Sum>(s_max[w][r]) - m);
      }
    }
    const long long at = static_cast<long long>(h) * gridDim.x * R + row0 + r;
    rowmax[at] = m;
    rowsum[at] = static_cast<float>(sum);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` over n_groups × H thread blocks.  Q is (H, n_rows, d),
// Kmat (H, k_rows, d), logits (H, n_chunks, V, K), rowmax/rowsum
// (H, n_groups·R), all contiguous float32.  Returns the cudaError_t of the
// launch (0 = success).
int repro_sddmm_softmax_f32(const void* colidx, const void* lrow,
                            const void* trow, const void* vals,
                            const void* groups, int n_groups, int n_chunks,
                            const void* Q, int n_rows, const void* Kmat,
                            int k_rows, int d, int H, int V, int R, int K,
                            float scale, float slope, void* logits,
                            void* rowmax, void* rowsum, void* stream) {
  if (n_groups <= 0 || H <= 0) return 0;
  if ((V != 1 && V != 2) || R < 1 || R > kMaxR || K < 1 || d < 0 ||
      H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kern = V == 1 ? sddmm_softmax_kernel<1> : sddmm_softmax_kernel<2>;
  dim3 grid(static_cast<unsigned>(n_groups), static_cast<unsigned>(H));
  kern<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(colidx), static_cast<const int*>(lrow),
      static_cast<const int*>(trow), static_cast<const float*>(vals),
      static_cast<const int*>(groups), n_chunks,
      static_cast<const float*>(Q), n_rows, static_cast<const float*>(Kmat),
      k_rows, d, R, K, scale, slope, static_cast<float*>(logits),
      static_cast<float*>(rowmax), static_cast<float*>(rowsum));
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
