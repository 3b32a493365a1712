// Selective scan (the Mamba recurrence) for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel
// src/repro/kernels/selective_scan/kernel.py::selective_scan_kernel (body
// _kernel).  For dA, dBx (B, S, N, Di), C (B, S, N) it computes, per batch
// row b and state column di,
//   h_t[n] = dA_t[n] · h_{t−1}[n] + dBx_t[n]        (h_{−1} = 0)
//   y_t    = Σ_n h_t[n] · C_t[n]                    → y (B, S, Di)
// and the hidden states never reach device memory.
//
// Design.  The TPU kernel runs its grid in sequence and keeps the (N, tile)
// state in VMEM across its sequence chunks, reset at chunk 0.  Thread
// blocks here run in no order and carry nothing between them, so one block
// owns a (b, 16-column Di slice) for the whole sequence and walks it in a
// loop: one thread per state element (n, di), its h in a register.  That
// gives B·N·Di threads (102,400 for Hymba at B = 2), not the B·Di dependent
// chains of a thread per column.  Neighbouring threads take neighbouring
// di, so each load of dA or dBx is two 64-byte runs per warp.  The loop
// takes kT = 8 time steps at a time: the next chunk's dA, dBx and C are
// loaded into registers before the current one is computed (they do not
// depend on h), so two chunks' loads are in flight.  The Σ_n crosses
// warps: each thread writes h·C for its kT steps into shared memory, one
// __syncthreads, and the block's threads sum over n, kT·16 outputs at a
// time, and write y.  Shared memory is double-buffered by chunk, so one
// barrier per chunk suffices: a thread writes buffer k%2 again only after
// passing chunk k+1's barrier, which every thread reaches after its chunk-k
// reads.  Ragged S and Di are bounds-checked (a missing step or column
// reads as dA = 1, dBx = 0, C = 0 and writes nothing); nothing is padded.
// Offsets are 64-bit: B·S·N·Di passes 2^31 at 32k tokens.
//
// Rounding.  h = fmaf(dA, h, dBx) is one rounding where the plain version
// has two, and the Σ_n runs in order n = 0..N−1, so results agree with the
// plain version to about 1e-6 relative, not bit for bit.
//
// Bound on this card.  dA and dBx are read once (8 bytes per state
// element and step), C and y once; 2 FLOPs per element and step are far
// below any peak, so the kernel is bytes-bound: for (2, 2048, 16, 3200)
// 1.73 GB, 0.52 ms at 3.35 TB/s.  Keeping enough bytes in flight with
// 1–3 blocks per SM is the limit; a later change could take wider loads
// (float4) and more steps per chunk.
//
// Hidden states for the backward.  Given an `h` pointer the forward also
// writes every h_t (B, S, N, Di), 4 more bytes per state element and step.
// The write is a template parameter (kKeepH), so a null `h` launches the
// forward above, bit for bit and with the same loop.
//
// Backward (repro_selective_scan_bwd_f32).  The reference takes the scan's
// gradient by XLA autodiff of its associative scan
// (src/repro/models/ssm.py:82-86); its Pallas kernel has none.  For the
// output cotangent gy (B, S, Di), walking t from S − 1 down to 0,
//   gh_t     = gy_t · C_t + dA_{t+1} ⊙ gh_{t+1}      (gh_S = 0)
//   g_dBx_t  = gh_t
//   g_dA_t   = gh_t ⊙ h_{t−1}                        (h_{−1} = 0)
//   g_C_t[n] = Σ_d gy_t[d] · h_t[n, d]
// with the forward's layout: one block per (b, 16-column Di slice), one
// thread per (n, di), gh in a register, 8-step chunks whose loads (dA_t,
// h_{t−1}, gy_t, C_t) are issued a chunk ahead.  The Σ_d of g_C runs over
// the block's 16 columns, which are 16 consecutive lanes of one warp: a
// butterfly of warp shuffles in a fixed order (no shared memory, no
// barrier).  Each block writes its partial sums to (B, ⌈Di/16⌉, S, N) and
// the wrapper sums them over the slices with one torch.sum: no atomics, so
// two launches give the same bits.  Bytes-bound like the forward: dA and
// h read, g_dA and g_dBx written, 16 bytes per state element and step.
#include <cuda_runtime.h>

namespace {

constexpr int kTD = 16;   // Di columns per block
constexpr int kT = 8;     // time steps per chunk

__device__ __forceinline__ void load_chunk(
    const float* __restrict__ pa, const float* __restrict__ px,
    const float* __restrict__ pc, long long t0, long long S, long long step,
    int N, bool live, float (&a)[kT], float (&x)[kT], float (&c)[kT]) {
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const long long t = t0 + i;
    const bool in = t < S;
    a[i] = in && live ? __ldg(pa + t * step) : 1.f;
    x[i] = in && live ? __ldg(px + t * step) : 0.f;
    c[i] = in ? __ldg(pc + t * N) : 0.f;
  }
}

template <bool kKeepH>
__global__ void __launch_bounds__(32 * kTD)
selective_scan_kernel(const float* __restrict__ dA,
                      const float* __restrict__ dBx,
                      const float* __restrict__ C, long long S, int N,
                      int Di, float* __restrict__ y,
                      float* __restrict__ hout) {
  extern __shared__ float part[];               // [2][kT][N][kTD]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;              // N · kTD
  const int n = tid / kTD;
  const int dl = tid - n * kTD;
  const int d0 = blockIdx.x * kTD;
  const bool live = d0 + dl < Di;
  const long long b = blockIdx.y;
  const long long step = static_cast<long long>(N) * Di;   // one time step
  const long long off = (b * S * N + n) * Di + (live ? d0 + dl : 0);
  const float* pa = dA + off;
  const float* px = dBx + off;
  const float* pc = C + b * S * N + n;
  float* py = y + b * S * Di + d0;
  float* ph = kKeepH ? hout + off : nullptr;

  float a[kT], x[kT], c[kT], na[kT], nx[kT], nc[kT];
  load_chunk(pa, px, pc, 0, S, step, N, live, a, x, c);
  float h = 0.f;
  int buf = 0;
  for (long long t0 = 0; t0 < S; t0 += kT) {
    load_chunk(pa, px, pc, t0 + kT, S, step, N, live, na, nx, nc);
    float* sp = part + buf * kT * N * kTD;
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      h = fmaf(a[i], h, x[i]);
      sp[(i * N + n) * kTD + dl] = h * c[i];
      if (kKeepH && live && t0 + i < S) ph[(t0 + i) * step] = h;
    }
    __syncthreads();
    for (int o = tid; o < kT * kTD; o += nthreads) {
      const int i = o / kTD;
      const int dd = o - i * kTD;
      const long long t = t0 + i;
      if (t < S && d0 + dd < Di) {
        const float* q = sp + i * N * kTD + dd;
        float s = 0.f;
        for (int m = 0; m < N; ++m) s += q[m * kTD];
        py[t * Di + dd] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      a[i] = na[i];
      x[i] = nx[i];
      c[i] = nc[i];
    }
    buf ^= 1;
  }
}

__device__ __forceinline__ void load_chunk_bwd(
    const float* __restrict__ pa, const float* __restrict__ ph,
    const float* __restrict__ pg, const float* __restrict__ pc, long long t1,
    long long step, int Di, int N, bool live, float (&a)[kT],
    float (&hm)[kT], float (&g)[kT], float (&c)[kT]) {
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const long long t = t1 - 1 - i;       // steps t1 − 1 down to t1 − kT
    const bool in = t >= 0;
    a[i] = in && live ? __ldg(pa + t * step) : 0.f;
    hm[i] = t >= 1 && live ? __ldg(ph + (t - 1) * step) : 0.f;
    g[i] = in && live ? __ldg(pg + t * Di) : 0.f;
    c[i] = in ? __ldg(pc + t * N) : 0.f;
  }
}

__global__ void __launch_bounds__(32 * kTD)
selective_scan_bwd_kernel(const float* __restrict__ dA,
                          const float* __restrict__ C,
                          const float* __restrict__ hs,
                          const float* __restrict__ gy, long long S, int N,
                          int Di, float* __restrict__ g_dA,
                          float* __restrict__ g_dBx,
                          float* __restrict__ g_Cpart) {
  const int tid = threadIdx.x;
  const int n = tid / kTD;
  const int dl = tid - n * kTD;
  const int d0 = blockIdx.x * kTD;
  const bool live = d0 + dl < Di;
  const long long b = blockIdx.y;
  const long long step = static_cast<long long>(N) * Di;
  const long long off = (b * S * N + n) * Di + (live ? d0 + dl : 0);
  const float* pa = dA + off;
  const float* ph = hs + off;
  const float* pg = gy + b * S * Di + (live ? d0 + dl : 0);
  const float* pc = C + b * S * N + n;
  float* pga = g_dA + off;
  float* pgx = g_dBx + off;
  // this block's partial Σ_d of g_C: (B, ⌈Di/16⌉, S, N)
  float* pgc = g_Cpart + (b * gridDim.x + blockIdx.x) * S * N + n;
  // the 16 lanes of one n are one half of a warp; a warp of a block with
  // an odd N has only its lower half
  const int warp0 = tid & ~31;
  const unsigned mask = blockDim.x - warp0 >= 32
                            ? 0xffffffffu
                            : (1u << (blockDim.x - warp0)) - 1u;

  float a[kT], hm[kT], g[kT], c[kT], na[kT], nhm[kT], ng[kT], nc[kT];
  load_chunk_bwd(pa, ph, pg, pc, S, step, Di, N, live, a, hm, g, c);
  float gh = 0.f;
  float a_next = 0.f;                                      // dA_{t+1}
  float h_t = live ? __ldg(ph + (S - 1) * step) : 0.f;     // h_{S−1}
  for (long long t1 = S; t1 > 0; t1 -= kT) {
    load_chunk_bwd(pa, ph, pg, pc, t1 - kT, step, Di, N, live, na, nhm, ng,
                   nc);
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const long long t = t1 - 1 - i;
      if (t < 0) break;                     // uniform across the block
      gh = fmaf(a_next, gh, g[i] * c[i]);
      if (live) {
        pgx[t * step] = gh;
        pga[t * step] = gh * hm[i];
      }
      float s = g[i] * h_t;
#pragma unroll
      for (int o = kTD / 2; o > 0; o >>= 1) s += __shfl_xor_sync(mask, s, o);
      if (dl == 0) pgc[t * N] = s;
      a_next = a[i];
      h_t = hm[i];
    }
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      a[i] = na[i];
      hm[i] = nhm[i];
      g[i] = ng[i];
      c[i] = nc[i];
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`.  dA and dBx are contiguous (B, S, N, Di) float32, C
// (B, S, N), y (B, S, Di); h, when not null, (B, S, N, Di) receives every
// hidden state.  Takes 1 ≤ N ≤ 32 and B ≤ 65535.  Returns the cudaError_t
// of the launch (0 = success).
int repro_selective_scan_f32(const void* dA, const void* dBx, const void* C,
                             int B, long long S, int N, int Di, void* y,
                             void* h, void* stream) {
  if (B <= 0 || S <= 0 || Di <= 0) return 0;
  if (N < 1 || N > 32 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((Di + kTD - 1) / kTD),
                  static_cast<unsigned>(B));
  const size_t smem = 2 * sizeof(float) * kT * N * kTD;
  const auto kernel = h == nullptr ? selective_scan_kernel<false>
                                   : selective_scan_kernel<true>;
  kernel<<<grid, N * kTD, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dA), static_cast<const float*>(dBx),
      static_cast<const float*>(C), S, N, Di, static_cast<float*>(y),
      static_cast<float*>(h));
  return static_cast<int>(cudaGetLastError());
}

// The backward, on `stream`.  dA and h (the forward's hidden states) are
// contiguous (B, S, N, Di) float32, C (B, S, N), gy (B, S, Di); writes
// g_dA and g_dBx (B, S, N, Di) and g_Cpart (B, ⌈Di/16⌉, S, N), the per-slice
// partial sums of g_C.  The same limits as the forward.  Returns the
// cudaError_t of the launch (0 = success).
int repro_selective_scan_bwd_f32(const void* dA, const void* C,
                                 const void* h, const void* gy, int B,
                                 long long S, int N, int Di, void* g_dA,
                                 void* g_dBx, void* g_Cpart, void* stream) {
  if (B <= 0 || S <= 0 || Di <= 0) return 0;
  if (N < 1 || N > 32 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((Di + kTD - 1) / kTD),
                  static_cast<unsigned>(B));
  selective_scan_bwd_kernel<<<grid, N * kTD, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dA), static_cast<const float*>(C),
      static_cast<const float*>(h), static_cast<const float*>(gy), S, N, Di,
      static_cast<float*>(g_dA), static_cast<float*>(g_dBx),
      static_cast<float*>(g_Cpart));
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
