// ParamSpMM for Hopper (sm_90a): C = act(scale ⊙ (A·B) + bias + residual)
// with A held as covered PCSR steering arrays, optionally with the softmax
// prologue of the GAT message.
//
// Replaces the TPU kernel src/repro/kernels/paramspmm/kernel.py::
// paramspmm_kernel (body _kernel): its plain gather-scatter, its fused
// epilogue and its softmax prologue (kernel.py:83-93).  bf16 operands are
// not ported yet.
//
// What bounds it.  Per real slot the kernel gathers one row of B (one
// Dblk-wide tile of it, dim·4 bytes in all) and reads the slot's steering
// (colidx, lrow, V values); it writes the (n_rows, dim) output once.  The
// MACs (2·nnz·dim) are far below the float32 peak, and B (tens of MB) sits
// in the 50 MB L2, so the floor is the steering and output traffic over HBM
// bandwidth.  What kept the first design (one thread block per chunk group,
// one thread per column) far from that floor was latency: each slot was a
// dependent chain of loads (vals → colidx → B row → update) with one
// gathered row in flight per thread, and a power-law graph's hub group
// (rmat17: 21,989 slots in one block) was one block's serial walk.
//
// Design.
// * Work units (host-built, kernels/paramspmm/ops.py::work_units): a unit
//   is a contiguous slot range of at most `cap` real slots inside one chunk
//   group, cut at chunk boundaries.  The grid is (units, dim tiles, heads).
//   A group that is one unit is written directly with the epilogue fused;
//   the units of a split group write float32 partial (R, Dblk) tiles into a
//   workspace, and paramspmm_merge_kernel sums each split group's partials
//   in unit order, then applies the epilogue once (scale, bias, residual,
//   activation, the reference's order).  A unit with begin = end and a split
//   with no partials are padding (a serving bucket pads its tables to fixed
//   bounds, so one captured grid fits every batch): their blocks return at
//   once and write nothing.  No atomics: the same inputs give
//   the same bits on every run, and sums of integer-valued operands are
//   exact in any fixed order.  Coverage chunks give every empty block a
//   group, so every output row is written and gets bias and activation.
// * Steering staged in shared memory: the unit's colidx, lrow and values
//   are copied 256 slots at a time with cp.async, double-buffered, so the
//   next tile's copies are in flight while this one is used.  A pass over
//   each staged tile marks padding slots (colidx −1) and, under the
//   prologue, turns each logit into α once per slot (lanes over slots),
//   from the block's R guarded row stats cached in shared memory.
// * Many gathered rows in flight: LS lanes cover one slot's tile row with
//   VW-wide vector loads (float4 where dim allows; float2, float), so a
//   warp takes 32/LS slots per step when the tile is narrow (d = 64: two),
//   and each lane group issues kUnroll independent B-row loads before it
//   uses any of them.  Each lane group (a "stream") accumulates into its
//   own copy of the (R, Dblk) tile in shared memory, so no two threads
//   touch one word; the copies are summed in stream order at the unit's
//   end.  Copies fit a 64 KB budget (R·Dblk·4 bytes each, R ≤ 32,
//   Dblk ≤ 512), which caps how many streams a block has; the fullest unit
//   sets how many it gets, and each block uses only as many as its own
//   unit keeps busy, so a small unit zeroes and sums few copies.  The
//   staging buffers shrink to the longest unit where that is under 256.
//
// Prologue.  With rowmax/rowsum given, the slot values are the GAT logits
// of sddmm_softmax.cu (masked and padding slots −inf); α = exp(logit −
// m)/s with the NaN-proof guards (m finite → m, else 0; s > 0 and finite
// → s, else 1), never written to device memory.  Skipping: without the
// prologue a slot whose V values are all 0 (padding, coverage and filler
// chunks) adds exactly zero and is skipped; under the prologue a logit of
// exactly 0 is a real edge, so the test is on −inf, never on 0.  Stats are
// indexed by the explicit block count (h·n_blocks·R + row), not the grid.
//
// What is left: the accumulator copies cost a zeroing and a summing pass
// per unit; B rows are float32 (bf16 would halve the gathered bytes); TMA
// and wgmma do not apply to row gathers of this width.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "steering.h"

namespace {

constexpr int kStage = 256;        // staged slots per tile, at most
constexpr int kUnroll = 4;         // B-row loads in flight per lane group
constexpr int kMaxThreads = 512;
constexpr int kMaxR = 32;
constexpr int kThreadTarget = 256;
constexpr size_t kTileBudget = 64 * 1024;   // bytes of accumulator copies
// dynamic shared memory a launch may ask for: the copies' budget plus the
// staging of kStage slots with V = 2
constexpr size_t kMaxSmem = kTileBudget + 2 * kStage * (2 + 2) * 4;
constexpr int kMergeThreads = 256;
constexpr int kMergeBatch = 8;     // partial loads in flight per element

template <int VW> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<1> { using T = float; };

__device__ __forceinline__ void axpy(float* acc, float a, float4 b) {
  float4* p = reinterpret_cast<float4*>(acc);
  float4 x = *p;
  x.x += a * b.x; x.y += a * b.y; x.z += a * b.z; x.w += a * b.w;
  *p = x;
}
__device__ __forceinline__ void axpy(float* acc, float a, float2 b) {
  float2* p = reinterpret_cast<float2*>(acc);
  float2 x = *p;
  x.x += a * b.x; x.y += a * b.y;
  *p = x;
}
__device__ __forceinline__ void axpy(float* acc, float a, float b) {
  *acc += a * b;
}

// α of one slot from its logit and its row's guarded softmax stats.
__device__ __forceinline__ float softmax_weight(float logit, float m,
                                                float s) {
  return __fdiv_rn(expf(__fsub_rn(logit, m)), s);
}

// The epilogue, in the reference's order: scale, bias, residual, act.
__device__ __forceinline__ float epilogue(float y, long long row, int col,
                                          int dim, const float* scale,
                                          const float* bias,
                                          const float* residual,
                                          int activation, float slope) {
  if (scale) y = __fmul_rn(y, __ldg(scale + row));
  if (bias) y = __fadd_rn(y, __ldg(bias + col));
  if (residual) y = __fadd_rn(y, __ldg(residual + row * dim + col));
  if (activation == 1) {
    y = fmaxf(y, 0.f);
  } else if (activation == 2) {
    y = y >= 0.f ? y : __fmul_rn(slope, y);
  }
  return y;
}

struct Geometry {
  int ls_log2;   // lanes per slot = 1 << ls_log2
  int cg;        // column groups (LS = 32 when cg > 1)
  int cols;      // tile columns held per copy (cg · LS · VW ≥ Dblk used)
  int stage;     // staged slots per tile
};

template <int V, int VW, bool kPrologue>
__global__ void __launch_bounds__(kMaxThreads)
paramspmm_kernel(const int* __restrict__ colidx, const int* __restrict__ lrow,
                 const int* __restrict__ trow, const float* __restrict__ vals,
                 const int4* __restrict__ units, int n_chunks, int n_blocks,
                 const float* __restrict__ B, int b_rows, int dim,
                 const float* __restrict__ rowmax,
                 const float* __restrict__ rowsum,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ residual,
                 float* __restrict__ out, float* __restrict__ partial,
                 int n_partials, int n_rows, int R, int K, int dblk,
                 Geometry geo, int activation, float slope) {
  using Vec = typename VecOf<VW>::T;
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_m[kMaxR], s_s[kMaxR];
  const int LS = 1 << geo.ls_log2;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int sl = tid & (LS - 1);
  const int cgi = (tid >> geo.ls_log2) % geo.cg;
  const int stream = (tid >> geo.ls_log2) / geo.cg;
  const int copy_floats = R * geo.cols;
  const int ts = geo.stage;
  float* acc = smem;                            // [streams][R][cols]
  int* st_col =
      reinterpret_cast<int*>(acc + nt / (LS * geo.cg) * copy_floats);
  int* st_row = st_col + 2 * ts;                // [2][ts]
  float* st_val = reinterpret_cast<float*>(st_row + 2 * ts);  // [2][V][ts]

  const int4 u = units[blockIdx.x];
  if (u.x >= u.y) return;       // a padding unit of a bucket's fixed grid
  const long long h = blockIdx.z;
  const int col0 = blockIdx.y * dblk;
  const int wt = min(dblk, dim - col0);
  const int col = (cgi * LS + sl) * VW;         // tile-local column
  const bool active = col < wt;
  const long long row0 = static_cast<long long>(__ldg(trow + u.x / K)) * R;
  vals += h * n_chunks * V * K;
  B += h * b_rows * dim + col0;
  // streams this unit keeps busy (each at least 2·kUnroll slots)
  const int n_streams = min(nt / (LS * geo.cg),
                            max(1, (u.y - u.x + 2 * kUnroll - 1) /
                                       (2 * kUnroll)));

  const int n_tiles = (u.y - u.x + ts - 1) / ts;
  auto stage = [&](int t) {
    const int buf = t & 1;
    const int base = u.x + t * ts;
    const int n = min(ts, u.y - base);
    for (int i = tid; i < n; i += nt) {
      const int slot = base + i;
      const int c = slot / K;
      const long long vk = static_cast<long long>(c) * V * K + (slot - c * K);
      __pipeline_memcpy_async(st_col + buf * ts + i, colidx + slot, 4);
      __pipeline_memcpy_async(st_row + buf * ts + i, lrow + slot, 4);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        __pipeline_memcpy_async(st_val + (buf * V + v) * ts + i,
                                vals + vk + v * K, 4);
      }
    }
    __pipeline_commit();
  };
  stage(0);                      // in flight while the copies are zeroed

  Vec* acc_v = reinterpret_cast<Vec*>(acc);    // copies as VW-vectors
  for (int e = tid; e < n_streams * copy_floats / VW; e += nt) {
    acc_v[e] = Vec{};
  }
  for (int r = tid; kPrologue && r < R; r += nt) {
    const long long at = h * n_blocks * R + row0 + r;
    const float m = __ldg(rowmax + at);
    const float s = __ldg(rowsum + at);
    s_m[r] = isfinite(m) ? m : 0.f;
    s_s[r] = s > 0.f && isfinite(s) ? s : 1.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int buf = t & 1;
    const int n = min(ts, u.y - (u.x + t * ts));
    int* sc = st_col + buf * ts;
    const int* sr = st_row + buf * ts;
    float* sv = st_val + buf * V * ts;
    // mark padding slots; under the prologue, α once per slot
    for (int i = tid; i < n; i += nt) {
      const float kEmpty = kPrologue ? -CUDART_INF_F : 0.f;
      bool live = false;
#pragma unroll
      for (int v = 0; v < V; ++v) live = live || sv[v * ts + i] != kEmpty;
      if (!live) {
        sc[i] = -1;
      } else if (kPrologue) {
        const int r = sr[i] * V;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          sv[v * ts + i] =
              softmax_weight(sv[v * ts + i], s_m[r + v], s_s[r + v]);
        }
      }
    }
    __syncthreads();
    if (stream < n_streams) {
      float* mine = acc + stream * copy_floats + col;
      for (int i0 = 0; i0 < n; i0 += n_streams * kUnroll) {
        Vec b[kUnroll];
        float a[kUnroll][V];
        int r[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {   // the loads first, all of them
          const int i = i0 + k * n_streams + stream;
          r[k] = -1;
          const int brow = i < n ? sc[i] : -1;
          if (brow >= 0) {
            r[k] = sr[i] * V;
#pragma unroll
            for (int v = 0; v < V; ++v) a[k][v] = sv[v * ts + i];
            if (active) {
              b[k] = __ldg(reinterpret_cast<const Vec*>(
                  B + static_cast<long long>(brow) * dim + col));
            }
          }
        }
        if (active) {
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {   // then the updates, in order
            if (r[k] < 0) continue;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              axpy(mine + (r[k] + v) * geo.cols, a[k][v], b[k]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // sum the copies in stream order; write the tile or its partial, a
  // VW-vector per thread
  const int wv = wt / VW;                       // vectors per tile row
  const int cv = geo.cols / VW;
  for (int e = tid; e < R * wv; e += nt) {
    const int r = e / wv;
    const int col = col0 + (e - r * wv) * VW;
    const Vec* a = acc_v + r * cv + (e - r * wv);
    Vec y = a[0];
    float* yf = reinterpret_cast<float*>(&y);
    for (int s = 1; s < n_streams; ++s) {
      const float* xf =
          reinterpret_cast<const float*>(a + s * (copy_floats / VW));
#pragma unroll
      for (int k = 0; k < VW; ++k) yf[k] += xf[k];
    }
    if (u.w >= 0) {
      *reinterpret_cast<Vec*>(
          partial + ((h * n_partials + u.w) * R + r) * dim + col) = y;
      continue;
    }
    const long long row = row0 + r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      yf[k] = epilogue(yf[k], row, col + k, dim, scale, bias, residual,
                       activation, slope);
    }
    *reinterpret_cast<Vec*>(out + (h * n_rows + row) * dim + col) = y;
  }
}

// One thread per output element of a split group (blocks over (split
// group, dim tile × element slice, head)): the group's partials summed in
// unit order, kMergeBatch loads in flight at a time, then the epilogue, as
// the single-unit path applies it.
__global__ void __launch_bounds__(kMergeThreads)
paramspmm_merge_kernel(const int* __restrict__ splits,
                       const float* __restrict__ partial, int n_partials,
                       int dim, int R, int dblk, int slices,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const float* __restrict__ residual,
                       float* __restrict__ out, int n_rows, int activation,
                       float slope) {
  const int block = splits[3 * blockIdx.x];
  const int p0 = splits[3 * blockIdx.x + 1];
  const int p1 = splits[3 * blockIdx.x + 2];
  if (p1 <= p0) return;         // a padding split: no partials, no block
  const long long h = blockIdx.z;
  const int col0 = blockIdx.y / slices * dblk;
  const int wt = min(dblk, dim - col0);
  const int e = blockIdx.y % slices * kMergeThreads + threadIdx.x;
  if (e >= R * wt) return;
  const int r = e / wt;
  const long long row = static_cast<long long>(block) * R + r;
  if (row >= n_rows) return;
  const int col = col0 + e - r * wt;
  const long long stride = static_cast<long long>(R) * dim;
  const float* p = partial + ((h * n_partials + p0) * R + r) * dim + col;
  float y = p[0];
  for (int q = 1; q < p1 - p0; q += kMergeBatch) {
    float x[kMergeBatch];
#pragma unroll
    for (int k = 0; k < kMergeBatch; ++k) {
      x[k] = q + k < p1 - p0 ? p[(q + k) * stride] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kMergeBatch; ++k) {
      if (q + k < p1 - p0) y += x[k];
    }
  }
  out[(h * n_rows + row) * dim + col] =
      epilogue(y, row, col, dim, scale, bias, residual, activation, slope);
}

template <int V, int VW, bool kPrologue>
cudaError_t launch(dim3 grid, int nt, size_t smem, cudaStream_t stream,
                   const int* colidx, const int* lrow, const int* trow,
                   const float* vals, const int4* units, int n_chunks,
                   int n_blocks, const float* B, int b_rows, int dim,
                   const float* rowmax, const float* rowsum,
                   const float* scale, const float* bias,
                   const float* residual, float* out, float* partial,
                   int n_partials, int n_rows, int R, int K, int dblk,
                   Geometry geo, int activation, float slope) {
  auto kern = paramspmm_kernel<V, VW, kPrologue>;
  // allow the most any launch asks for, once per device: setting it on
  // every launch costs a small launch more host time than its kernel
  static unsigned allowed = 0;        // bit d: set on device d
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (!(allowed >> device & 1u)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return e;
    allowed |= 1u << device;
  }
  kern<<<grid, nt, smem, stream>>>(colidx, lrow, trow, vals, units, n_chunks,
                                   n_blocks, B, b_rows, dim, rowmax, rowsum,
                                   scale, bias, residual, out, partial,
                                   n_partials, n_rows, R, K, dblk, geo,
                                   activation, slope);
  return cudaGetLastError();
}

template <int V, bool kPrologue>
auto pick(int vw) {
  return vw == 4 ? launch<V, 4, kPrologue>
                 : vw == 2 ? launch<V, 2, kPrologue> : launch<V, 1, kPrologue>;
}

}  // namespace

extern "C" {

// Launch on `stream`: the unit kernel over n_units × ceil(dim/dblk) × H
// thread blocks, then, when some group is split (n_splits > 0), the merge
// over n_splits × ceil(dim/dblk) × H.  vals (the slot values used, the
// stored ones or given ones) is (H, n_chunks, V, K), B (H, b_rows, dim),
// out (H, n_rows, dim), rowmax/rowsum (H, n_blocks·R), partial
// (H, n_partials, R, dim), all contiguous float32.  rowmax and rowsum
// (both or neither) turn on the softmax prologue; scale/bias/residual may
// be null.  activation: 0 none, 1 relu, 2 leaky_relu.  vw ∈ {1, 2, 4} is
// the B load width (dim and B's address must allow it).  Returns the
// cudaError_t of the launches (0 = success).
int repro_paramspmm_f32(const SteeringArgs* st, const void* vals,
                        void* partial, const void* B, int b_rows, int dim,
                        const void* rowmax, const void* rowsum,
                        const void* scale, const void* bias,
                        const void* residual, void* out, int n_rows, int H,
                        int V, int R, int K, int dblk, int vw,
                        int activation, float slope, void* stream) {
  if (st->n_units <= 0 || dim <= 0 || n_rows <= 0 || H <= 0) return 0;
  if ((V != 1 && V != 2) || R < 1 || R > kMaxR || dblk < 1 ||
      dblk > kMaxThreads || H > 65535 || (vw != 1 && vw != 2 && vw != 4) ||
      dim % vw != 0 || dblk % vw != 0 ||
      (rowmax == nullptr) != (rowsum == nullptr) ||
      (st->n_splits > 0 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int J = (dim + dblk - 1) / dblk;
  const int nvec = (dblk < dim ? dblk : dim) / vw;
  Geometry geo;
  int ls = 1;
  while (ls < nvec && ls < 32) ls *= 2;
  geo.ls_log2 = __builtin_ctz(ls);
  geo.cg = (nvec + ls - 1) / ls;
  geo.cols = geo.cg * ls * vw;
  const size_t copy_bytes = static_cast<size_t>(R) * geo.cols * sizeof(float);
  // streams: as many as the thread target and the copies' budget allow,
  // and no more than the fullest unit keeps busy (2·kUnroll slots each);
  // each block then uses as many as its own unit keeps busy
  int n_streams = kThreadTarget / (geo.cg * ls);
  const int fit = static_cast<int>(kTileBudget / copy_bytes);
  const int busy = (st->most + 2 * kUnroll - 1) / (2 * kUnroll);
  if (n_streams > fit) n_streams = fit;
  if (n_streams > busy) n_streams = busy;
  const int warp = 32 / (geo.cg * ls);    // at least one warp a block
  if (n_streams < warp && warp <= fit) n_streams = warp;
  if (n_streams < 1) n_streams = 1;
  const int nt = n_streams * geo.cg * ls;
  geo.stage = st->span < kStage ? (st->span + 31) / 32 * 32 : kStage;
  const size_t smem = n_streams * copy_bytes + 2 * geo.stage * (2 + V) * 4;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(st->n_units), static_cast<unsigned>(J),
            static_cast<unsigned>(H));
  auto go = V == 1 ? (rowmax ? pick<1, true>(vw) : pick<1, false>(vw))
                   : (rowmax ? pick<2, true>(vw) : pick<2, false>(vw));
  cudaError_t e = go(
      grid, nt, smem, cs, st->colidx, st->lrow, st->trow,
      static_cast<const float*>(vals), st->units, st->n_chunks, st->n_blocks,
      static_cast<const float*>(B), b_rows, dim,
      static_cast<const float*>(rowmax), static_cast<const float*>(rowsum),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(residual), static_cast<float*>(out),
      static_cast<float*>(partial), st->n_partials, n_rows, R, K, dblk, geo,
      activation, slope);
  if (e != cudaSuccess || st->n_splits == 0) return static_cast<int>(e);
  const int wt = dblk < dim ? dblk : dim;
  const int slices = (R * wt + kMergeThreads - 1) / kMergeThreads;
  dim3 mgrid(static_cast<unsigned>(st->n_splits),
             static_cast<unsigned>(J * slices), static_cast<unsigned>(H));
  paramspmm_merge_kernel<<<mgrid, kMergeThreads, 0, cs>>>(
      st->splits, static_cast<const float*>(partial), st->n_partials, dim, R, dblk, slices, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(residual),
      static_cast<float*>(out), n_rows, activation, slope);
  return static_cast<int>(cudaGetLastError());
}

int repro_steering_args_size() {
  return static_cast<int>(sizeof(SteeringArgs));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
