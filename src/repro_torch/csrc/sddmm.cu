// Raw SDDMM for Hopper (sm_90a), float32: E = (A≠0) ⊙ (Q·Kmatᵀ) in PCSR
// slot layout — the GAT backward's dα = SDDMM(pcsr, dOut, Vf).
//
// Replaces the TPU kernel src/repro/kernels/sddmm/kernel.py::sddmm_kernel
// (body _kernel) together with its wrapper's sampling mask
// (src/repro/kernels/sddmm/ops.py:77-79).  For every slot (c, v, k) of the
// covered PCSR steering, with row = trow[c]·R + lrow[c·K+k]·V + v:
//   E[c, v, k] = Q[row] · Kmat[colidx[c·K+k]]   where vals[c, v, k] ≠ 0
//              = 0                               elsewhere
// "Elsewhere" is padding, coverage chunks and explicit zeros: they are
// written as exactly 0, never left unwritten, because the softmax vjp
// multiplies them by α = 0 and 0·NaN would poison the gradient.
//
// Design.  The TPU grid (C, K, J) walks one chunk's slots in order and
// accumulates each slot's dot across dim tiles in VMEM.  No two slots
// share an output here, so the kernel needs neither the chunk-group table
// nor an owner per group: it is slot-parallel.  One warp computes one slot
// (all V of its rows), its lanes splitting the feature dim d (coalesced
// reads of the gathered Kmat row and the V Q rows), then a shuffle
// reduction; lane 0 writes the V results.  Warps stride over the slots
// (grid-stride loop), so a power-law hub's many chunks spread over every
// SM instead of one thread block's serial walk.  Heads are grid axis y
// over the single-head steering: head h reads Q, Kmat and writes E at its
// own offsets.  Q rows ≥ n_rows (block padding) are never loaded.
// Integer-valued operands give results bit-equal to the plain version
// (their partial sums are exact in any order).
//
// Bound on this card.  Per real slot the kernel gathers one row of Kmat
// and reads V rows of Q (d·4 bytes each) and writes V·4 bytes; read once
// each, Q, Kmat, the steering and E are the byte floor, and the 2·nnz·d
// MACs are far below the float32 peak, so it is bytes-bound — in practice
// latency-bound on the dependent chain vals → colidx → Kmat row, which
// the many warps in flight hide.  A later change could keep a chunk's
// steering in shared memory and give each warp several slots in flight.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr long long kMaxBlocks = 16384;   // grid-stride beyond this

template <int V>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const int* __restrict__ colidx, const int* __restrict__ lrow,
             const int* __restrict__ trow, const float* __restrict__ vals,
             long long n_slots, const float* __restrict__ Q, int n_rows,
             const float* __restrict__ Kmat, int k_rows, int d, int R, int K,
             float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long h = blockIdx.y;
  Q += h * n_rows * d;
  Kmat += h * k_rows * d;
  out += h * n_slots * V;

  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long slot = static_cast<long long>(blockIdx.x) * kWarps +
                        (threadIdx.x >> 5);
       slot < n_slots; slot += stride) {
    const long long c = slot / K;
    const long long k = slot - c * K;
    const float* vc = vals + c * V * K + k;       // vals[c, v, k] at vc[v·K]
    float* o = out + c * V * K + k;
    const long long row0 =
        static_cast<long long>(__ldg(trow + c)) * R + __ldg(lrow + slot) * V;
    bool real[V];
    bool any = false;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      real[v] = __ldg(vc + v * K) != 0.f && row0 + v < n_rows;
      any = any || real[v];
    }
    if (!any) {                                   // padding: exactly 0
      if (lane < V) o[lane * K] = 0.f;
      continue;
    }
    const float* krow = Kmat + static_cast<long long>(__ldg(colidx + slot)) * d;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float kv = __ldg(krow + i);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (real[v]) acc[v] += __ldg(Q + (row0 + v) * d + i) * kv;
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
      for (int v = 0; v < V; ++v) o[v * K] = real[v] ? acc[v] : 0.f;
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`.  colidx/lrow are (n_chunks·K,) int32, trow
// (n_chunks,), vals (n_chunks, V, K) float32; Q is (H, n_rows, d), Kmat
// (H, k_rows, d), out (H, n_chunks, V, K), all contiguous float32.
// Returns the cudaError_t of the launch (0 = success).
int repro_sddmm_f32(const void* colidx, const void* lrow, const void* trow,
                    const void* vals, int n_chunks, const void* Q,
                    int n_rows, const void* Kmat, int k_rows, int d, int H,
                    int V, int R, int K, void* out, void* stream) {
  if (n_chunks <= 0 || H <= 0) return 0;
  if ((V != 1 && V != 2) || R < 1 || K < 1 || d < 0 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_slots = static_cast<long long>(n_chunks) * K;
  long long blocks = (n_slots + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  auto kern = V == 1 ? sddmm_kernel<1> : sddmm_kernel<2>;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(H));
  kern<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(colidx), static_cast<const int*>(lrow),
      static_cast<const int*>(trow), static_cast<const float*>(vals),
      n_slots, static_cast<const float*>(Q), n_rows,
      static_cast<const float*>(Kmat), k_rows, d, R, K,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
