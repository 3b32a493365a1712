// The GAT backward's slot pass for Hopper (sm_90a), float32: the softmax
// vjp and LeakyReLU′ on A's slots, and the transfer of de and α onto Aᵀ's
// slots, in one launch.
//
// Replaces no TPU kernel.  The reference leaves this pass to XLA, which
// fuses the elementwise vjp around its gathers (src/repro/core/engine.py,
// the GAT message's f_bwd).  In the port it replaces the PyTorch chain
// between the raw SDDMM (dα, csrc/sddmm.cu) and the three backward SpMMs
// (csrc/paramspmm.cu): row-stat gathers, the vjp's elementwise passes and
// two slot transfers (zero-fill, int64 gather, int64 scatter), ~15 passes
// over (H, C, V, K) slot tensors.  Per head h, for every covered slot s of
// A, with row = trow[c]·R + lrow[c·K+k]·V + v (core/engine.py::_slot_rows):
//   α  = expf(logit − rm[row]) / den[row]   (rm = rowmax where finite,
//        else 0; den = rowsum where > 0 and finite, else 1: the guards of
//        core/engine.py::normalize_from_stats)
//   dx = α · (dα − rowdot[row])
//   de = (dx · scale) · (logit ≥ 0 ? 1 : slope)
// and it writes de in A's layout (for dQ = SpMM(A, de, K)) and, on every
// covered slot t of Aᵀ, de_T[t] = de[src[t]] and α_T[t] = α[src[t]]
// (for dK and dVf on Aᵀ); src[t] = −1 (no edge) writes exact 0.  Each
// output is written only when asked for (a null pointer skips it), and
// every element of an output is written, so the wrapper allocates them
// uninitialised.  The float32 operations and their order are those of the
// plain version (kernels/sddmm/ops.py::gat_backward_plain): expf and IEEE
// division (no fast math), and no product feeds a sum, so FMA contraction
// cannot change a bit; no atomics, so two launches give the same bits.
//
// What bounds it: bytes.  Read once, logits and dα (2·H·n_a floats), the
// row stats (3·H·n_seg, L2-resident), the steering rows and the int32 map
// (n_t); written once, de (H·n_a) and de_T, α_T (2·H·n_t).  At the
// gat8h.train.rmat18 shapes (H = 8, n_a = n_t = 8,412,960 covered slots,
// 7,873,048 edges) that is 1.44 GB a layer, 0.43 ms at 3.35 TB/s.  The
// transfer is a permutation with no locality: gathered straight from the
// head-major slot tensors, each head's value of an edge sits in its own
// 32-byte sector, 16 sectors an edge at 8 heads.  This design moves the
// scratch rows besides (written once, gathered once: 2.52 GB a layer).
//
// Design.  One cooperative launch of at most as many blocks as fit on the
// card at once, in two phases separated by a grid-wide barrier.  Phase 1
// walks A's slots in order, 256 a block, one a thread, every head in the
// thread (four heads' loads issued before their stores): coalesced reads
// of logits and dα, the row stats through L1/L2, and a coalesced write of
// de.  It also writes what Aᵀ needs of the slot —
// de and/or α of every head, W = H·(need_k + need_v) floats — as one
// slot-major row of a scratch array (n_a × W, from the wrapper), staged
// through shared memory so that the block writes its 256 rows as one
// contiguous run.  Phase 2 walks Aᵀ's slots in order, one a thread: one
// int32 src read, one gather of the W-float row (16- or 8-byte loads,
// whole sectors: 64 bytes an edge at 8 heads against 16 × 32 when read
// from the head-major tensors), and coalesced writes of de_T and α_T,
// zeros where src is −1.  Phase 2 never reads dα, so the wrapper may hand
// dα's storage back as one of the Aᵀ outputs once the pass is done.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// the staged rows: 256 × (W + 1) floats (+1: no bank conflicts) within
// the 48 KB a launch gets without opting in; wider rows go straight out
constexpr int kMaxStagedWidth = 46;
constexpr int kBatch = 4;      // phase 2: vector loads of a row in flight
constexpr int kHeads = 4;      // phase 1: heads whose loads are in flight

struct Params {
  const float* logits;   // (H, n_a)
  const float* dalpha;   // (H, n_a), null when de and de_t are
  const float* rowmax;   // (H, n_seg)
  const float* rowsum;   // (H, n_seg)
  const float* rowdot;   // (H, n_seg), null when de and de_t are
  const int* lrow;       // (n_a / V,)
  const int* trow;       // (n_a / (V·K),)
  const int* src;        // (n_t,): A's covered flat slot, or −1
  float* de;             // (H, n_a) or null
  float* de_t;           // (H, n_t) or null
  float* alpha_t;        // (H, n_t) or null; may be dα's storage
  float* work;           // (n_a, W), null when de_t and alpha_t are
  long long n_a, n_t;
  int H, V, K, R, n_seg;
  int np;                // values a head carries to Aᵀ: 1 or 2
  float scale, slope;
};

// Phase 1, in A's slot order.
__device__ void a_side(const Params& p, float* tile) {
  const int W = p.H * p.np;
  const bool staged = p.work != nullptr && W <= kMaxStagedWidth;
  const bool need_dx = p.de != nullptr || p.de_t != nullptr;
  const int VK = p.V * p.K;
  const long long n_tiles = (p.n_a + kThreads - 1) / kThreads;
  for (long long ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const long long s0 = ti * kThreads;
    const long long s = s0 + threadIdx.x;
    if (s < p.n_a) {
      const long long c = s / VK;
      const int rem = static_cast<int>(s - c * VK);
      const int v = rem / p.K;
      const int k = rem - v * p.K;
      const long long row =
          static_cast<long long>(__ldg(p.trow + c)) * p.R +
          static_cast<long long>(__ldg(p.lrow + c * p.K + k)) * p.V + v;
      float* row_out = nullptr;     // where this slot's W values go
      if (p.work != nullptr) {
        row_out = staged ? tile + threadIdx.x * (W + 1) : p.work + s * W;
      }
      // kHeads heads at a time: their loads all issued before the
      // stores they feed
      for (int h0 = 0; h0 < p.H; h0 += kHeads) {
        float l[kHeads], rm[kHeads], den[kHeads], da[kHeads], rd[kHeads];
#pragma unroll
        for (int j = 0; j < kHeads; ++j) {
          if (h0 + j >= p.H) break;
          const long long ia = (h0 + j) * p.n_a + s;
          const long long ir = static_cast<long long>(h0 + j) * p.n_seg + row;
          l[j] = __ldg(p.logits + ia);
          rm[j] = __ldg(p.rowmax + ir);
          den[j] = __ldg(p.rowsum + ir);
          if (need_dx) {
            da[j] = __ldg(p.dalpha + ia);
            rd[j] = __ldg(p.rowdot + ir);
          }
        }
#pragma unroll
        for (int j = 0; j < kHeads; ++j) {
          const int h = h0 + j;
          if (h >= p.H) break;
          const float m = isfinite(rm[j]) ? rm[j] : 0.f;
          const float d = (den[j] > 0.f && isfinite(den[j])) ? den[j] : 1.f;
          const float a = expf(l[j] - m) / d;
          float e = 0.f;
          if (need_dx) {
            const float dx = a * (da[j] - rd[j]);
            e = (dx * p.scale) * (l[j] >= 0.f ? 1.f : p.slope);
            if (p.de != nullptr) p.de[h * p.n_a + s] = e;
          }
          if (row_out != nullptr) {
            // a head's values in the row: [de if de_t][α if alpha_t]
            float* dst = row_out + h * p.np;
            if (p.de_t != nullptr) *dst++ = e;
            if (p.alpha_t != nullptr) *dst = a;
          }
        }
      }
    }
    if (staged) {
      __syncthreads();
      const long long left = p.n_a - s0;
      const long long n = (left < kThreads ? left : kThreads) * W;
      float* out = p.work + s0 * W;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int r = i / W;
        out[i] = tile[r * (W + 1) + (i - r * W)];
      }
      __syncthreads();
    }
  }
}

template <int VW> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<1> { using T = float; };

// Phase 2, in Aᵀ's slot order.  `work` is written by phase 1 of this
// launch, so it is read with plain loads, never through the read-only
// cache.
template <int VW>
__device__ void t_side(const Params& p) {
  using Vec = typename VecOf<VW>::T;
  const int W = p.H * p.np;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       t < p.n_t; t += stride) {
    const int s = __ldg(p.src + t);
    if (s < 0) {
      for (int h = 0; h < p.H; ++h) {
        if (p.de_t != nullptr) p.de_t[h * p.n_t + t] = 0.f;
        if (p.alpha_t != nullptr) p.alpha_t[h * p.n_t + t] = 0.f;
      }
      continue;
    }
    const Vec* row = reinterpret_cast<const Vec*>(
        p.work + static_cast<long long>(s) * W);
    // kBatch loads of the row in flight before the stores they feed
    for (int q0 = 0; q0 < W; q0 += kBatch * VW) {
      Vec x[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (q0 + b * VW < W) x[b] = row[q0 / VW + b];
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const float* xs = reinterpret_cast<const float*>(&x[b]);
#pragma unroll
        for (int i = 0; i < VW; ++i) {
          const int q = q0 + b * VW + i;
          if (q >= W) break;
          const int h = p.np == 2 ? q >> 1 : q;
          const bool is_de =
              p.de_t != nullptr && (p.np == 1 || (q & 1) == 0);
          (is_de ? p.de_t : p.alpha_t)[h * p.n_t + t] = xs[i];
        }
      }
    }
  }
}

template <int VW>
__global__ void __launch_bounds__(kThreads) gat_backward_slots(Params p) {
  extern __shared__ __align__(16) float tile[];
  a_side(p, tile);
  if (p.work != nullptr) {
    cg::this_grid().sync();
    t_side<VW>(p);
  }
}

template <int VW>
cudaError_t launch(Params p, cudaStream_t stream) {
  const int W = p.H * p.np;
  const size_t smem = (p.work != nullptr && W <= kMaxStagedWidth)
                          ? static_cast<size_t>(kThreads) * (W + 1) * 4
                          : 0;
  const void* fn = reinterpret_cast<const void*>(&gat_backward_slots<VW>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long slots = p.n_a;
  if (p.work != nullptr) slots = std::max(slots, p.n_t);
  const long long want = std::max(1LL, (slots + kThreads - 1) / kThreads);
  const long long grid =
      std::min(want, static_cast<long long>(sms) * per_sm);
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(grid)),
                                     dim3(kThreads), args, smem, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`.  logits and dalpha are (H, n_a) with n_a = C·V·K
// over A's covered steering (lrow (C·K,), trow (C,)); the stats and rowdot
// (H, n_seg); src (n_t,) over Aᵀ's covered slots; de (H, n_a), de_t and
// alpha_t (H, n_t); work n_a·H·np floats with np = (de_t ≠ null) +
// (alpha_t ≠ null).  All contiguous float32 / int32.  A null output is not
// computed; dalpha and rowdot are needed for de or de_t, src and work for
// de_t or alpha_t.  Returns the cudaError_t of the launch (0 = success).
int repro_gat_backward_f32(const void* logits, const void* dalpha,
                           const void* rowmax, const void* rowsum,
                           const void* rowdot, const void* lrow,
                           const void* trow, const void* src, long long n_a,
                           long long n_t, int H, int V, int K, int R,
                           int n_seg, float scale, float slope, void* de,
                           void* de_t, void* alpha_t, void* work,
                           void* stream) {
  Params p;
  p.logits = static_cast<const float*>(logits);
  p.dalpha = static_cast<const float*>(dalpha);
  p.rowmax = static_cast<const float*>(rowmax);
  p.rowsum = static_cast<const float*>(rowsum);
  p.rowdot = static_cast<const float*>(rowdot);
  p.lrow = static_cast<const int*>(lrow);
  p.trow = static_cast<const int*>(trow);
  p.src = static_cast<const int*>(src);
  p.de = static_cast<float*>(de);
  p.de_t = static_cast<float*>(de_t);
  p.alpha_t = static_cast<float*>(alpha_t);
  p.work = static_cast<float*>(work);
  p.n_a = n_a;
  p.n_t = n_t;
  p.H = H;
  p.V = V;
  p.K = K;
  p.R = R;
  p.n_seg = n_seg;
  p.np = (de_t != nullptr) + (alpha_t != nullptr);
  p.scale = scale;
  p.slope = slope;
  const bool need_dx = de != nullptr || de_t != nullptr;
  if (H < 0 || V < 1 || K < 1 || R < 1 || n_seg < 0 || n_a < 0 ||
      n_t < 0 || n_a % (static_cast<long long>(V) * K) != 0 ||
      (need_dx && (dalpha == nullptr || rowdot == nullptr)) ||
      ((p.np > 0) != (work != nullptr && src != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H == 0 || (de == nullptr && p.np == 0)) return 0;
  const int W = H * p.np;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = W % 4 == 0   ? launch<4>(p, s)
                          : W % 2 == 0 ? launch<2>(p, s)
                                       : launch<1>(p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
