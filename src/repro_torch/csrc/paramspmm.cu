// ParamSpMM for Hopper (sm_90a): C = act(scale ⊙ (A·B) + bias + residual)
// with A held as covered PCSR steering arrays.
//
// Replaces the TPU kernel src/repro/kernels/paramspmm/kernel.py::
// paramspmm_kernel (body _kernel), its plain gather-scatter and its fused
// epilogue.  The softmax prologue and bf16 operands are not ported yet.
//
// Design.  The TPU kernel is race-free only because its (J, C, K) grid runs
// in order: the split chunks of one output block accumulate in VMEM across
// consecutive revisits.  Thread blocks here run concurrently, so one thread
// block owns one (chunk group, dim tile): a chunk group is the maximal run of
// chunks with the same trow (init = 1 on its first chunk, fini = 1 on its
// last), listed by the host-built table `groups` (n_groups + 1 starts).  The
// block walks its group's chunks in order, accumulates the (R, Dblk) output
// tile in shared memory (thread t owns column t of the tile, so no two
// threads touch one word and no barrier is needed), applies the epilogue
// once at the group's end and writes the tile back.  Deterministic, no
// atomics, epilogue fused.  Coverage chunks give every empty block a group,
// so every output row is written and receives bias and activation.  A slot
// whose V values are all zero (padding, coverage and filler chunks) is
// skipped: for finite B it would add exactly zero.
//
// Bound on this card.  Per nonzero vector the kernel gathers one row of B
// (dim·4 bytes) and reads its slot (colidx, lrow, V values); it writes the
// (n_rows, dim) output once.  With B resident in L2 the floor is the
// output write plus the steering reads over HBM bandwidth; a cold B adds
// its bytes.  The MACs (2·nnz·dim) are far below the float32 peak.
//
// What a later change should do: the gather of B rows is a dependent load
// chain per slot (colidx → B), so prefetch a chunk's colidx/lrow/vals into
// shared memory and keep several gathered rows in flight (cp.async or TMA);
// split a skewed group (one hub block with many chunks) across several
// thread blocks with a second reduction pass or the paper's TRow + atomicAdd
// variant, since one thread block walks it serially.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;   // Dblk ≤ 4·128 columns, one per thread

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
paramspmm_kernel(const int* __restrict__ colidx, const int* __restrict__ lrow,
                 const int* __restrict__ trow, const float* __restrict__ vals,
                 const int* __restrict__ groups,
                 const float* __restrict__ B, int dim,
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

  for (int r = 0; r < R; ++r) acc[r * nt + t] = 0.f;
  const int c0 = groups[blockIdx.x];
  const int c1 = groups[blockIdx.x + 1];
  for (int c = c0; c < c1; ++c) {
    const long long base = static_cast<long long>(c) * K;
    const float* vc = vals + base * V;
    for (int k = 0; k < K; ++k) {
      const float a0 = __ldg(vc + k);
      const float a1 = V == 2 ? __ldg(vc + K + k) : 0.f;
      if (a0 == 0.f && a1 == 0.f) continue;      // padding slot
      const long long brow = __ldg(colidx + base + k);
      const float b = __ldg(B + brow * dim + col);
      float* a = acc + __ldg(lrow + base + k) * V * nt + t;
      a[0] += a0 * b;
      if (V == 2) a[nt] += a1 * b;
    }
  }

  // epilogue, in the reference's order: scale, bias, residual, activation
  const long long row0 = static_cast<long long>(__ldg(trow + c0)) * R;
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

}  // namespace

extern "C" {

// Launch on `stream`.  Returns the cudaError_t of the launch (0 = success).
// activation: 0 none, 1 relu, 2 leaky_relu.  scale/bias/residual may be null.
int repro_paramspmm_f32(const void* colidx, const void* lrow,
                        const void* trow, const void* vals,
                        const void* groups, int n_groups, const void* B,
                        int dim, const void* scale, const void* bias,
                        const void* residual, void* out, int n_rows, int V,
                        int R, int K, int dblk, int activation, float slope,
                        void* stream) {
  if (n_groups <= 0 || dim <= 0 || n_rows <= 0) return 0;
  if ((V != 1 && V != 2) || R < 1 || R > 32 || dblk < 1 ||
      dblk > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int J = (dim + dblk - 1) / dblk;
  const int dim32 = (dim + 31) / 32 * 32;
  const int nt = dblk < dim32 ? dblk : dim32;
  const size_t smem = static_cast<size_t>(R) * nt * sizeof(float);
  auto kern = V == 1 ? paramspmm_kernel<1> : paramspmm_kernel<2>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(static_cast<unsigned>(n_groups), static_cast<unsigned>(J));
  kern<<<grid, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(colidx), static_cast<const int*>(lrow),
      static_cast<const int*>(trow), static_cast<const float*>(vals),
      static_cast<const int*>(groups), static_cast<const float*>(B), dim,
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(residual), static_cast<float*>(out), n_rows,
      R, K, dblk, activation, slope);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
