// ParamSpMM for Hopper (sm_90a): C = act(scale ⊙ (A·B) + bias + residual)
// with A held as covered PCSR steering arrays, optionally with the softmax
// prologue of the GAT message.
//
// Replaces the TPU kernel src/repro/kernels/paramspmm/kernel.py::
// paramspmm_kernel (body _kernel): its plain gather-scatter, its fused
// epilogue and its softmax prologue (kernel.py:83-93).  bf16 operands are
// not ported yet.
//
// Design.  The TPU kernel is race-free only because its (J, C, K) grid runs
// in order: the split chunks of one output block accumulate in VMEM across
// consecutive revisits.  Thread blocks here run concurrently, so one thread
// block owns one (chunk group, dim tile, head): a chunk group is the maximal
// run of chunks with the same trow (init = 1 on its first chunk, fini = 1 on
// its last), listed by the host-built table `groups` (n_groups + 1 starts).
// The block walks its group's chunks in order, accumulates the (R, Dblk)
// output tile in shared memory (thread t owns column t of the tile, so no
// two threads touch one word and no barrier is needed), applies the
// epilogue once at the group's end and writes the tile back.
// Deterministic, no atomics, epilogue fused.  Coverage chunks give every
// empty block a group, so every output row is written and receives bias and
// activation.  Heads are grid axis z over the single-head steering: head h
// reads its own slot values, B and stats and writes its own output.
//
// Prologue.  With rowmax/rowsum given, the slot values are the GAT logits
// of sddmm_softmax.cu (masked and padding slots −inf) and each thread turns
// a slot's logit into α = exp(logit − m)/s in registers, with the NaN-proof
// guards (m finite → m, else 0; s > 0 and finite → s, else 1), so α is
// never written to device memory.  Skipping: without the prologue a slot
// whose V values are all 0 (padding, coverage and filler chunks) adds
// exactly zero and is skipped; under the prologue a logit of exactly 0 is
// a real edge, so the test is on −inf (α = 0), never on 0.
//
// Bound on this card.  Per nonzero vector the kernel gathers one row of B
// (dim·4 bytes) and reads its slot (colidx, lrow, V values, and under the
// prologue two stats per row); it writes the (n_rows, dim) output once.
// With B resident in L2 the floor is the output write plus the steering
// reads over HBM bandwidth; a cold B adds its bytes.  The MACs (2·nnz·dim)
// are far below the float32 peak.
//
// What a later change should do: the gather of B rows is a dependent load
// chain per slot (colidx → B), so prefetch a chunk's colidx/lrow/vals into
// shared memory and keep several gathered rows in flight (cp.async or TMA);
// split a skewed group (one hub block with many chunks) across several
// thread blocks with a second reduction pass or the paper's TRow + atomicAdd
// variant, since one thread block walks it serially; under the prologue,
// compute a chunk's α once per block rather than once per thread.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 512;   // Dblk ≤ 4·128 columns, one per thread

// α of one slot from its logit and its row's softmax stats.
__device__ __forceinline__ float softmax_weight(float logit, float m,
                                                float s) {
  m = isfinite(m) ? m : 0.f;
  s = s > 0.f && isfinite(s) ? s : 1.f;
  return __fdiv_rn(expf(__fsub_rn(logit, m)), s);
}

template <int V, bool kPrologue>
__global__ void __launch_bounds__(kMaxThreads)
paramspmm_kernel(const int* __restrict__ colidx, const int* __restrict__ lrow,
                 const int* __restrict__ trow, const float* __restrict__ vals,
                 const int* __restrict__ groups, int n_chunks,
                 const float* __restrict__ B, int b_rows, int dim,
                 const float* __restrict__ rowmax,
                 const float* __restrict__ rowsum,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ residual,
                 float* __restrict__ out, int n_rows, int R, int K, int dblk,
                 int activation, float slope) {
  extern __shared__ float acc[];                 // [R][blockDim.x]
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int col = blockIdx.y * dblk + t;
  if (col >= dim) return;                        // ragged column edge
  const long long h = blockIdx.z;
  vals += h * n_chunks * V * K;
  B += h * b_rows * dim;
  out += h * n_rows * dim;

  for (int r = 0; r < R; ++r) acc[r * nt + t] = 0.f;
  const int c0 = groups[blockIdx.x];
  const int c1 = groups[blockIdx.x + 1];
  const long long row0 = static_cast<long long>(__ldg(trow + c0)) * R;
  // this block's rows in the (H, n_groups·R) stats
  const long long srow = h * gridDim.x * R + row0;
  for (int c = c0; c < c1; ++c) {
    const long long base = static_cast<long long>(c) * K;
    const float* vc = vals + base * V;
    for (int k = 0; k < K; ++k) {
      const float kEmpty = kPrologue ? -CUDART_INF_F : 0.f;
      float a0 = __ldg(vc + k);
      float a1 = V == 2 ? __ldg(vc + K + k) : kEmpty;
      // padding slot: value 0, or logit −inf (α = 0) under the prologue
      if (a0 == kEmpty && a1 == kEmpty) continue;
      // the B row first: its load depends on colidx's and is the longest
      const long long brow = __ldg(colidx + base + k);
      const float b = __ldg(B + brow * dim + col);
      const int r = __ldg(lrow + base + k) * V;
      if (kPrologue) {
        a0 = softmax_weight(a0, __ldg(rowmax + srow + r),
                            __ldg(rowsum + srow + r));
        if (V == 2) {
          a1 = softmax_weight(a1, __ldg(rowmax + srow + r + 1),
                              __ldg(rowsum + srow + r + 1));
        }
      }
      float* a = acc + r * nt + t;
      a[0] += a0 * b;
      if (V == 2) a[nt] += a1 * b;
    }
  }

  // epilogue, in the reference's order: scale, bias, residual, activation
  for (int r = 0; r < R; ++r) {
    const long long row = row0 + r;
    if (row >= n_rows) break;
    float y = acc[r * nt + t];
    if (scale) y = __fmul_rn(y, __ldg(scale + row));
    if (bias) y = __fadd_rn(y, __ldg(bias + col));
    if (residual) y = __fadd_rn(y, __ldg(residual + row * dim + col));
    if (activation == 1) {
      y = fmaxf(y, 0.f);
    } else if (activation == 2) {
      y = y >= 0.f ? y : __fmul_rn(slope, y);
    }
    out[row * dim + col] = y;
  }
}

template <int V, bool kPrologue>
cudaError_t launch(dim3 grid, int nt, size_t smem, cudaStream_t stream,
                   const int* colidx, const int* lrow, const int* trow,
                   const float* vals, const int* groups, int n_chunks,
                   const float* B, int b_rows, int dim, const float* rowmax,
                   const float* rowsum, const float* scale, const float* bias,
                   const float* residual, float* out, int n_rows, int R,
                   int K, int dblk, int activation, float slope) {
  auto kern = paramspmm_kernel<V, kPrologue>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, nt, smem, stream>>>(colidx, lrow, trow, vals, groups,
                                   n_chunks, B, b_rows, dim, rowmax, rowsum,
                                   scale, bias, residual, out, n_rows, R, K,
                                   dblk, activation, slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` over n_groups × ceil(dim/dblk) × H thread blocks.
// vals is (H, n_chunks, V, K), B (H, b_rows, dim), out (H, n_rows, dim),
// rowmax/rowsum (H, n_groups·R), all contiguous float32.  rowmax and rowsum
// (both or neither) turn on the softmax prologue; scale/bias/residual may
// be null.  activation: 0 none, 1 relu, 2 leaky_relu.  Returns the
// cudaError_t of the launch (0 = success).
int repro_paramspmm_f32(const void* colidx, const void* lrow,
                        const void* trow, const void* vals,
                        const void* groups, int n_groups, int n_chunks,
                        const void* B, int b_rows, int dim,
                        const void* rowmax, const void* rowsum,
                        const void* scale, const void* bias,
                        const void* residual, void* out, int n_rows, int H,
                        int V, int R, int K, int dblk, int activation,
                        float slope, void* stream) {
  if (n_groups <= 0 || dim <= 0 || n_rows <= 0 || H <= 0) return 0;
  if ((V != 1 && V != 2) || R < 1 || R > 32 || dblk < 1 ||
      dblk > kMaxThreads || H > 65535 ||
      (rowmax == nullptr) != (rowsum == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int J = (dim + dblk - 1) / dblk;
  const int dim32 = (dim + 31) / 32 * 32;
  const int nt = dblk < dim32 ? dblk : dim32;
  const size_t smem = static_cast<size_t>(R) * nt * sizeof(float);
  dim3 grid(static_cast<unsigned>(n_groups), static_cast<unsigned>(J),
            static_cast<unsigned>(H));
  auto go = V == 1 ? (rowmax ? launch<1, true> : launch<1, false>)
                   : (rowmax ? launch<2, true> : launch<2, false>);
  return static_cast<int>(go(
      grid, nt, smem, static_cast<cudaStream_t>(stream),
      static_cast<const int*>(colidx), static_cast<const int*>(lrow),
      static_cast<const int*>(trow), static_cast<const float*>(vals),
      static_cast<const int*>(groups), n_chunks,
      static_cast<const float*>(B), b_rows, dim,
      static_cast<const float*>(rowmax), static_cast<const float*>(rowsum),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(residual), static_cast<float*>(out), n_rows,
      R, K, dblk, activation, slope));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
