// Raw SDDMM for Hopper (sm_90a), float32: E = (A≠0) ⊙ (Q·Kmatᵀ) in PCSR
// slot layout — the GAT backward's dα = SDDMM(pcsr, dOut, Vf).
//
// Replaces the TPU kernel src/repro/kernels/sddmm/kernel.py::sddmm_kernel
// (body _kernel) together with its wrapper's sampling mask
// (src/repro/kernels/sddmm/ops.py:77-79).  For every slot (c, v, k) of the
// covered PCSR steering, with row = trow[c]·R + lrow[c·K+k]·V + v:
//   E[c, v, k] = Q[row] · Kmat[colidx[c·K+k]]   where vals[c, v, k] ≠ 0
//                                               and row < n_rows
//              = 0                               elsewhere
// "Elsewhere" is padding, coverage chunks and explicit zeros: they are
// written as exactly 0, never left unwritten (the wrapper allocates the
// output uninitialised, and the softmax vjp multiplies these slots by
// α = 0, where 0·NaN would poison the gradient).
//
// What bounds it.  Read once, Q and Kmat (n·d floats each), the pattern as
// CSR and one float written per nonzero are the byte floor; the 2·nnz·d
// MACs are far below the float32 peak, so it is bytes-bound.  In practice
// every real slot gathers its Kmat row (d·4 bytes) through L2, and those
// gathers, not HBM, set the time once Kmat fits in L2; a slot that also
// gathered its Q row, or waited on its steering (vals → lrow → colidx)
// before its gather, would double the gathered bytes or add a chain of
// dependent loads per slot.
//
// Design.  The grid is (work units, heads) over the host-built unit table
// of kernels/paramspmm/ops.py::work_units, the one the GAT steering
// already carries for paramspmm.cu and sddmm_softmax.cu: a unit is a
// contiguous slot range of at most `cap` real slots inside one chunk
// group.  Slot outputs are disjoint, so units never collide: no partials
// and no merge.  For the same reason a unit can be cut anywhere: where
// units × heads give fewer than kTargetBlocks blocks (a small graph, whose
// few units each walk hundreds of slots in turn while SMs idle), each unit
// is cut into `parts` contiguous pieces of at least kMinPart slots, one
// block each.  A unit lies in one chunk group and so in one output row
// block, row0 = trow[c]·R: the block copies that block's R rows of Q into
// shared memory once per (piece, head) (rows ≥ n_rows are zeroed and never
// read), and each real slot then gathers only its Kmat row.  Where R·d
// floats exceed kQTileFloats, d is cut into column tiles as wide as the Q
// tile and each slot's dot is summed tile by tile in order; a d that fits
// is one tile of the same code.  The unit's steering (colidx, lrow, V
// vals) is staged in shared memory 256 slots at a time with cp.async,
// double-buffered, so a slot's one dependent load is its Kmat row.  LS
// lanes cover one dot with VW-wide loads (at d = 64: 16 lanes of float4,
// two slots per warp step), each lane group keeps kUnroll slots' Kmat
// loads in flight, and an xor-shuffle tree inside the lane group gives the
// dot.  Dots go to a staged tile in shared memory, and the block writes
// the tile's V runs of slots with consecutive threads on consecutive
// addresses, zeros included; a tile without a stored nonzero gathers
// nothing.  Heads are grid axis y: head h reads Q and Kmat and writes E at
// its own 64-bit offsets.  Integer-valued operands give results bit-equal
// to the plain version (their partial sums are exact in any order).
//
// What is left: Q and Kmat are float32 (bf16 would halve the gathered
// bytes), and a Kmat row that several slots of one unit share is gathered
// once per slot.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "steering.h"

namespace {

constexpr int kThreads = 128;
constexpr int kStage = 256;          // staged slots per tile
constexpr int kUnroll = 4;           // slots in flight per lane group
constexpr int kMaxR = 32;
constexpr int kMinLanes = 4;         // lanes per slot at least (≤ 32 groups)
constexpr int kQTileFloats = 4096;   // the Q tile: 16 KB of shared memory
constexpr int kTargetBlocks = 1024;  // cut units below this many blocks…
constexpr int kMinPart = 64;         // …into pieces of at least this many

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
sddmm_kernel(const int* __restrict__ colidx, const int* __restrict__ lrow,
             const int* __restrict__ trow, const float* __restrict__ vals,
             const int4* __restrict__ units, int n_chunks,
             const float* __restrict__ Q, int n_rows,
             const float* __restrict__ Kmat, int k_rows, int d, int R,
             int K, int parts, int tile_cols, int ls_log2,
             float* __restrict__ out) {
  using Vec = typename VecOf<VW>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LS = 1 << ls_log2;
  const int n_lg = kThreads >> ls_log2;
  const int tid = threadIdx.x;
  const int sl = tid & (LS - 1);
  const int lg = tid >> ls_log2;                    // lane group
  float* s_q = reinterpret_cast<float*>(smem_raw);  // [R][tile_cols]
  int* st_col =                                     // [2][kStage]
      reinterpret_cast<int*>(s_q + R * tile_cols);
  int* st_row = st_col + 2 * kStage;
  float* st_val =                                   // [2][V][kStage]
      reinterpret_cast<float*>(st_row + 2 * kStage);
  float* s_out = st_val + 2 * V * kStage;           // [V][kStage]

  // this block's slots [s0, s1): its unit, or with parts > 1 (a small
  // grid) its piece of the unit; one piece a unit skips the 64-bit
  // division, which would sit on every block's path to its first load
  const int4 u = units[parts == 1 ? blockIdx.x : blockIdx.x / parts];
  int s0 = u.x, s1 = u.y;
  if (parts > 1) {
    const long long len = u.y - u.x, part = blockIdx.x % parts;
    s0 = u.x + static_cast<int>(len * part / parts);
    s1 = u.x + static_cast<int>(len * (part + 1) / parts);
  }
  const int n_tiles = (s1 - s0 + kStage - 1) / kStage;
  if (n_tiles == 0) return;
  const long long h = blockIdx.y;
  const long long row0 = static_cast<long long>(__ldg(trow + u.x / K)) * R;
  Q += h * n_rows * d;
  Kmat += h * k_rows * d;
  out += h * n_chunks * V * K;
  const int n_dt = d > tile_cols ? (d + tile_cols - 1) / tile_cols : 1;

  // columns [c0, c0 + tile_cols) ∩ [0, d) of the block's R rows of Q into
  // s_q; rows ≥ n_rows are zeroed (no real slot reads them)
  auto load_q = [=](int dt) {
    const int c0 = dt * tile_cols;
    const int nv = (min(d, c0 + tile_cols) - c0) / VW;
    for (int e = tid; e < R * nv; e += kThreads) {
      const int r = e / nv;
      const int j = e - r * nv;
      float* dst = s_q + r * tile_cols + j * VW;
      if (row0 + r < n_rows) {
        __pipeline_memcpy_async(dst, Q + (row0 + r) * d + c0 + j * VW,
                                VW * 4);
      } else {
#pragma unroll
        for (int q = 0; q < VW; ++q) dst[q] = 0.f;
      }
    }
  };
  // the steering of tile t; thread tid copies slots tid, tid + kThreads, …
  auto stage = [=](int t) {
    const int buf = t & 1;
    const int base = s0 + t * kStage;
    const int n = min(kStage, s1 - base);
    for (int i = tid; i < n; i += kThreads) {
      const int slot = base + i;
      const int c = slot / K;
      const long long vk =
          static_cast<long long>(c) * V * K + (slot - c * K);
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

  load_q(0);
  stage(0);                       // one group: the Q tile and tile 0
  int have = 0;                   // the column tile s_q holds
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    const int buf = t & 1;
    const int base = s0 + t * kStage;
    const int n = min(kStage, s1 - base);
    const int* sc = st_col + buf * kStage;
    const int* sr = st_row + buf * kStage;
    const float* sv = st_val + buf * V * kStage;
    // each thread reads only the slots it copied itself; the barrier then
    // makes the tile (and the Q tile) visible to all
    bool mine = false;
    for (int i = tid; i < n; i += kThreads) {
#pragma unroll
      for (int v = 0; v < V; ++v) mine = mine || sv[v * kStage + i] != 0.f;
    }
    const bool any = __syncthreads_or(mine);
    if (any) {
      for (int dt = 0; dt < n_dt; ++dt) {
        if (dt != have) {          // d wider than the Q tile: next columns
          __syncthreads();
          load_q(dt);
          __pipeline_commit();
          __pipeline_wait_prior(0);
          __syncthreads();
          have = dt;
        }
        const int c0 = dt * tile_cols;
        const int nvec = (min(d, c0 + tile_cols) - c0) / VW;
        // one trip count for every lane of the block: the shuffles below
        // need each lane group of a warp to reach them together
        for (int i0 = 0; i0 < n; i0 += n_lg * kUnroll) {
          bool real[kUnroll][V];
          int qbase[kUnroll];      // the slot's first Q row in s_q
          const Vec* krow[kUnroll];
          float acc[kUnroll][V];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {
            const int i = i0 + k * n_lg + lg;
            krow[k] = nullptr;
            qbase[k] = 0;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              real[k][v] = false;
              acc[k][v] = 0.f;
            }
            if (i >= n) continue;
            const int r0 = sr[i] * V;
            qbase[k] = r0 * tile_cols;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              real[k][v] =
                  sv[v * kStage + i] != 0.f && row0 + r0 + v < n_rows;
              if (real[k][v]) {
                krow[k] = reinterpret_cast<const Vec*>(
                    Kmat + static_cast<long long>(sc[i]) * d + c0);
              }
            }
          }
          for (int j = sl; j < nvec; j += LS) {
            Vec kv[kUnroll];
#pragma unroll
            for (int k = 0; k < kUnroll; ++k) {
              if (krow[k]) kv[k] = __ldg(krow[k] + j);
            }
#pragma unroll
            for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                if (real[k][v]) {
                  const Vec q = reinterpret_cast<const Vec*>(
                      s_q + qbase[k] + v * tile_cols)[j];
                  acc[k][v] += dot(q, kv[k]);
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
#pragma unroll
              for (int v = 0; v < V; ++v) {
                float* o = s_out + v * kStage + i;
                if (dt == 0) {
                  *o = real[k][v] ? acc[k][v] : 0.f;
                } else if (real[k][v]) {
                  *o += acc[k][v];
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();
    // out[c, v, k] for the tile's slots: for each v, runs of consecutive k
    // inside a chunk, consecutive threads on consecutive addresses
#pragma unroll
    for (int v = 0; v < V; ++v) {
      for (int i = tid; i < n; i += kThreads) {
        const int slot = base + i;
        const int c = slot / K;
        out[static_cast<long long>(c) * V * K + v * K + (slot - c * K)] =
            any ? s_out[v * kStage + i] : 0.f;
      }
    }
    // no barrier here: the next tile writes s_out only after its own
    // __syncthreads_or, which every thread reaches after these stores
  }
}

template <int V, int VW>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const SteeringArgs* st, const float* Q, int n_rows,
                   const float* Kmat, int k_rows, int d, int R, int K,
                   int parts, int tile_cols, int ls_log2, float* out) {
  // smem ≤ 4·kQTileFloats + 2·256·4·4 + 2·256·4 bytes (V ≤ 2): under the
  // 48 KB a launch gets without opting in
  sddmm_kernel<V, VW><<<grid, kThreads, smem, stream>>>(
      st->colidx, st->lrow, st->trow, st->vals, st->units, st->n_chunks, Q,
      n_rows, Kmat, k_rows, d, R, K, parts, tile_cols, ls_log2, out);
  return cudaGetLastError();
}

template <int V>
auto pick(int vw) {
  return vw == 4 ? launch<V, 4> : vw == 2 ? launch<V, 2> : launch<V, 1>;
}

}  // namespace

extern "C" {

// Launch on `stream` over (st->n_units · parts) × H thread blocks.  Q is
// (H, n_rows, d), Kmat (H, k_rows, d), out (H, st->n_chunks, V, K), all
// contiguous float32; vw ∈ {1, 2, 4} is the load width (d and the
// addresses of Q and Kmat must allow it).  Returns the cudaError_t of the
// launch (0 = success).
int repro_sddmm_f32(const SteeringArgs* st, const void* Q, int n_rows,
                    const void* Kmat, int k_rows, int d, int H, int V,
                    int R, int K, int vw, void* out, void* stream) {
  if (st->n_units <= 0 || H <= 0) return 0;
  if ((V != 1 && V != 2) || R < 1 || R > kMaxR || K < 1 || d < 0 ||
      H > 65535 || (vw != 1 && vw != 2 && vw != 4) || d % vw != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the Q tile's width: all of d where R·d floats fit in kQTileFloats,
  // else the widest multiple of vw that does
  int tile_cols = d;
  if (static_cast<long long>(R) * d > kQTileFloats) {
    tile_cols = kQTileFloats / R / vw * vw;
  }
  if (tile_cols < vw) tile_cols = vw;                 // d = 0
  const int nvec = tile_cols / vw;
  int ls = kMinLanes;
  while (ls < nvec && ls < 32) ls *= 2;
  const size_t smem = static_cast<size_t>(R) * tile_cols * 4 +
                      2 * kStage * (2 + V) * 4 + V * kStage * 4;
  const long long blocks = static_cast<long long>(st->n_units) * H;
  long long parts = 1;
  if (blocks < kTargetBlocks) {
    parts = std::min((kTargetBlocks + blocks - 1) / blocks,
                     static_cast<long long>(st->span + kMinPart - 1) /
                         kMinPart);
    parts = std::max(parts, 1LL);
  }
  auto go = V == 1 ? pick<1>(vw) : pick<2>(vw);
  dim3 grid(static_cast<unsigned>(st->n_units * parts),
            static_cast<unsigned>(H));
  return static_cast<int>(go(
      grid, smem, static_cast<cudaStream_t>(stream), st,
      static_cast<const float*>(Q), n_rows,
      static_cast<const float*>(Kmat), k_rows, d, R, K,
      static_cast<int>(parts), tile_cols, __builtin_ctz(ls),
      static_cast<float*>(out)));
}

int repro_steering_args_size() {
  return static_cast<int>(sizeof(SteeringArgs));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
