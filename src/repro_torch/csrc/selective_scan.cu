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
// Forward design.  The TPU kernel runs its grid in sequence and keeps the
// (N, tile) state in VMEM across its sequence chunks, reset at chunk 0.
// Thread blocks here run in no order and carry nothing between them, so
// one block owns a (b, 16-column Di slice) for the whole sequence and
// walks it in a loop: one thread per state element (n, di), its h in a
// register.  That gives B·N·Di threads (102,400 for Hymba at B = 2), not
// the B·Di dependent chains of a thread per column.  Neighbouring threads
// take neighbouring di, so each load of dA or dBx is two 64-byte runs per
// warp.  The loop takes kT = 8 time steps at a time: the next chunk's dA,
// dBx and C are loaded into registers before the current one is computed
// (they do not depend on h), so two chunks' loads are in flight.  The Σ_n
// crosses warps: each thread writes h·C for its kT steps into shared
// memory, one __syncthreads, and the block's threads sum over n, kT·16
// outputs at a time, and write y.  Shared memory is double-buffered by
// chunk, so one barrier per chunk suffices: a thread writes buffer k%2
// again only after passing chunk k+1's barrier, which every thread
// reaches after its chunk-k reads.  Ragged S and Di are bounds-checked (a
// missing step or column reads as dA = 1, dBx = 0, C = 0 and writes
// nothing); nothing is padded.  Offsets are 64-bit: B·S·N·Di passes 2^31
// at 32k tokens.
//
// Rounding.  h = fmaf(dA, h, dBx) is one rounding where the plain version
// has two, and the Σ_n runs in order n = 0..N−1, so results agree with the
// plain version to about 1e-6 relative, not bit for bit.
//
// Forward bound on this card.  dA and dBx are read once (8 bytes per
// state element and step), C and y once; 2 FLOPs per element and step are
// far below any peak, so the kernel is bytes-bound: for (2, 2048, 16,
// 3200) and for (1, 4096, 16, 3200) 1.73 GB, 0.52 ms at 3.35 TB/s.
//
// Chunk states for the backward (the training forward).  Given a
// `states` pointer the forward also writes the hidden state at the end of
// every chunk of kChunk = 64 steps, states (B, ⌈S/64⌉, N, Di) with
// states[k] = h_{min(64(k+1), S) − 1}: 13 MB at (1, 4096, 16, 3200), where
// every h_t would be 839 MB.  The write is a template parameter
// (kStates) of the loop, so a null `states` launches the forward above,
// bit for bit and with the same loop.
//
// Backward (repro_selective_scan_bwd_f32).  The reference takes the scan's
// gradient by XLA autodiff of its associative scan
// (src/repro/models/ssm.py:82-86); its Pallas kernel has none.  For the
// output cotangent gy (B, S, Di), walking t from S − 1 down to 0,
//   gh_t     = gy_t · C_t + dA_{t+1} ⊙ gh_{t+1}      (gh_S = 0)
//   g_dBx_t  = gh_t
//   g_dA_t   = gh_t ⊙ h_{t−1}                        (h_{−1} = 0)
//   g_C_t[n] = Σ_d gy_t[d] · h_t[n, d]
//
// Backward bound.  dA and dBx read, g_dA and g_dBx written: 16 bytes per
// state element and step, and 2–4 FLOPs for them, so bytes bound it (no
// tensor-core form applies: there is no product to tile).  gy, C, g_C and
// the chunk states add under 2%: 3.42 GB, 1.02 ms at 3.35 TB/s at both
// (2, 2048, 16, 3200) and (1, 4096, 16, 3200).
//
// Backward design.  One block per (b, chunk of 64 steps, 32-column Di
// slice, group of 4 states n): 128 threads, one warp per n and one lane
// per di.  At (1, 4096, 16, 3200) that is 25,600 blocks, where a block per
// (b, Di slice) walking all of S gave 200: the time axis is cut, so B = 1
// fills the card as B = 2 does.  A block
//   1. copies its chunk's dA and dBx (32 KB each), gy and C into shared
//      memory with cp.async, 16 bytes a copy when Di is a multiple of 4,
//      all of them in flight at once and none staged through registers;
//   2. rebuilds h_t for the chunk from the chunk state before it, with
//      the forward's own fmaf, over dBx in place, so the h it uses are the
//      forward's bits;
//   3. walks the chunk backwards once with gh = 0 at its end, giving the
//      chunk's affine map of the cotangent carry: P_k = A_k·P_{k+1} + b_k,
//      where P_k = dA_{t0}·gh_{t0} is what chunk k passes to chunk k − 1
//      and A_k = Π dA over the chunk;
//   4. per thread, takes P_{k+1} from chunk k + 1 of its (b, n, di) and
//      publishes P_k: a chained scan in reverse chunk order.  A block
//      ticket (an atomic counter) hands out chunks from the last to the
//      first, so the chunk waited for belongs to a block that took its
//      ticket earlier and the wait always ends.  The carry's own bits are
//      the flag (scratch the wrapper sets to all ones), so there is no
//      fence and no barrier.  Its load is issued with the copies of step
//      1, so its L2 latency hides behind steps 1–3 and does not sit in
//      every block's critical path;
//   5. walks the chunk backwards again from gh = P_{k+1} and writes g_dA
//      and g_dBx (one 128-byte line a warp a step), leaving each step's
//      gy·h_t in the dA slot the walk is done with;
//   6. sums those over its 32 columns per step and n (each lane two
//      steps, in a fixed order) into g_Cpart (B, ⌈Di/32⌉, S, N), which the
//      wrapper sums over the slices: 26 MB at (1, 4096, 16, 3200), half
//      the 16-column slices'.  Done after the walk, this takes 64 shared
//      loads a lane, where a butterfly of warp shuffles per step would put
//      five dependent shuffles into every step of the walk.
// The carry crosses chunks with no h, so the backward reads 16 bytes per
// element and step, as the bound does, and no full h is ever stored.
// Every sum runs in a fixed order and no atomic adds values (the ticket
// counter orders blocks only), so two launches give the same bits.
//
// Chunk length.  kChunk = 64: a block's tiles take 73.5 KB of shared
// memory, so three blocks (12 warps, 220 KB) fit an SM.  A 128-step
// chunk would fit one block an SM; a 32-step chunk would write twice the
// states and make the chain of carries twice as long.  Tiles held in
// registers (128 a thread) would spill and stall the loads.
#include <cuda_runtime.h>

namespace {

constexpr int kTD = 16;      // forward: Di columns per block
constexpr int kT = 8;        // forward: time steps per loaded chunk
constexpr int kChunk = 64;   // steps per chunk state; the backward's tile
constexpr int kBwdTD = 32;   // backward: Di columns per block (a warp)
constexpr int kBwdTN = 4;    // backward: states n per block (a warp each)
static_assert(kBwdTD == 32, "a backward warp's lanes are its Di columns");
static_assert(kChunk % kT == 0, "a forward chunk of kT steps ends no later "
              "than its 64-step chunk");

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

template <bool kStates>
__device__ __forceinline__ void scan_forward(
    const float* __restrict__ dA, const float* __restrict__ dBx,
    const float* __restrict__ C, long long S, int N, int Di,
    float* __restrict__ y, float* __restrict__ states) {
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
  // states (B, ⌈S/kChunk⌉, N, Di) of this (b, n, di)
  float* ps = kStates ? states + (b * ((S + kChunk - 1) / kChunk) * N + n)
                                     * Di + (live ? d0 + dl : 0)
                      : nullptr;

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
    }
    // a chunk's last state (steps past S leave h as it is: 1·h + 0)
    if (kStates && live && (t0 + kT >= S || (t0 + kT) % kChunk == 0)) {
      *ps = h;
      ps += step;
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

__global__ void __launch_bounds__(32 * kTD)
selective_scan_kernel(const float* __restrict__ dA,
                      const float* __restrict__ dBx,
                      const float* __restrict__ C, long long S, int N,
                      int Di, float* __restrict__ y) {
  scan_forward<false>(dA, dBx, C, S, N, Di, y, nullptr);
}

// The training forward: the same loop, writing the chunk states.  With a
// minimum of one block an SM the compiler may take 128 registers a thread
// (it takes 112, two blocks an SM), which keeps the state write's cost
// near 2% at B = 2 (chip_compare.py scan, one H100); under the inference
// forward's bounds the write slowed the loop several times as much.
__global__ void __launch_bounds__(32 * kTD, 1)
selective_scan_states_kernel(const float* __restrict__ dA,
                             const float* __restrict__ dBx,
                             const float* __restrict__ C, long long S,
                             int N, int Di, float* __restrict__ y,
                             float* __restrict__ states) {
  scan_forward<true>(dA, dBx, C, S, N, Di, y, states);
}

// cp.async of `bytes` (4 or 16) from global to shared memory; an invalid
// source reads nothing and fills zeros.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(dst), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
  }
}

// The carry P_k crosses blocks as a float whose bits the wrapper sets to
// 0xffffffff before the launch (no float the kernel computes has them: a
// NaN it makes is 0x7fffffff), so the value is its own flag.  Relaxed
// loads and stores at GPU scope: no fence, and nothing else is ordered.
constexpr unsigned kUnset = 0xffffffffu;

__device__ __forceinline__ unsigned load_relaxed(const float* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(__float_as_uint(v)) : "memory");
}

// Shared memory of a backward block, in floats: dA of the chunk
// [step][n][d]; the state before the chunk, then dBx (rebuilt into h) of
// the chunk [1 + step][n][d]; gy [step][d]; C [step][n].
constexpr int kRow = kBwdTN * kBwdTD;
constexpr int kTile = kChunk * kRow;
constexpr int kBwdSmem = (2 * kTile + kRow + kChunk * kBwdTD
                          + kChunk * kBwdTN)
                         * static_cast<int>(sizeof(float));

// sync[0] is the ticket counter, zero at launch; carry (B, ⌈S/64⌉, N, Di)
// holds chunk k's P_k, every word 0xffffffff at launch.  kVec is the
// width of the copies of dA, dBx and gy: 16 bytes when Di is a multiple
// of 4, else 4.
template <int kVec>
__global__ void __launch_bounds__(32 * kBwdTN)
selective_scan_bwd_kernel(const float* __restrict__ dA,
                          const float* __restrict__ dBx,
                          const float* __restrict__ C,
                          const float* __restrict__ states,
                          const float* __restrict__ gy, int B, long long S,
                          int N, int Di, int nchunks, int nslices,
                          int ngroups, float* __restrict__ g_dA,
                          float* __restrict__ g_dBx,
                          float* __restrict__ g_Cpart, float* carry,
                          int* sync) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                             // [kChunk][kBwdTN][kBwdTD]
  float* sh = sa + kTile;                       // h_{t0−1}, then dBx → h
  float* sg = sh + kRow + kTile;                // [kChunk][kBwdTD]
  float* sc = sg + kChunk * kBwdTD;             // [kChunk][kBwdTN]
  __shared__ int ticket;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  if (tid == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  // tickets run over chunks from the last to the first; inside a chunk
  // over (b, slice, group), the groups of one slice side by side (they
  // share the slice's gy)
  const long long r = ticket;
  const long long per_b = static_cast<long long>(nslices) * ngroups;
  const long long per_chunk = per_b * B;
  const int k = nchunks - 1 - static_cast<int>(r / per_chunk);
  const long long b = (r % per_chunk) / per_b;
  const int d0 = static_cast<int>((r % per_b) / ngroups) * kBwdTD;
  const int n0 = static_cast<int>(r % ngroups) * kBwdTN;
  const long long t0 = static_cast<long long>(k) * kChunk;
  const int steps = static_cast<int>(S - t0 < kChunk ? S - t0 : kChunk);
  const long long step = static_cast<long long>(N) * Di;

  // 1. the chunk's tiles into shared memory, all copies in flight at once
  constexpr int kPer = kBwdTD / (kVec / 4);     // copies per (step, n) row
  for (int o = tid; o < kChunk * kBwdTN * kPer; o += 32 * kBwdTN) {
    const int i = o / (kBwdTN * kPer);
    const int nl = (o / kPer) % kBwdTN;
    const int dd = (o % kPer) * (kVec / 4);
    const bool ok = i < steps && n0 + nl < N && d0 + dd < Di;
    const long long g = ok ? (b * S + t0 + i) * step
                             + static_cast<long long>(n0 + nl) * Di + d0 + dd
                           : 0;
    cp_async<kVec>(sa + (i * kBwdTN + nl) * kBwdTD + dd, dA + g, ok);
    cp_async<kVec>(sh + kRow + (i * kBwdTN + nl) * kBwdTD + dd, dBx + g,
                   ok);
  }
  for (int o = tid; o < kChunk * kPer; o += 32 * kBwdTN) {
    const int i = o / kPer;
    const int dd = (o % kPer) * (kVec / 4);
    const bool ok = i < steps && d0 + dd < Di;
    cp_async<kVec>(sg + i * kBwdTD + dd,
                   gy + (ok ? (b * S + t0 + i) * Di + d0 + dd : 0), ok);
  }
  for (int o = tid; o < kChunk * kBwdTN; o += 32 * kBwdTN) {
    const int i = o / kBwdTN;
    const int nl = o % kBwdTN;
    const bool ok = i < steps && n0 + nl < N;
    cp_async<4>(sc + o, C + (ok ? (b * S + t0 + i) * N + n0 + nl : 0), ok);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  const int n = n0 + w;
  const int d = d0 + lane;
  const int len = n < N && d < Di ? steps : 0;  // this thread's steps
  const long long elem = len > 0 ? static_cast<long long>(n) * Di + d : 0;
  const long long chunk_elem = (b * nchunks + k) * step + elem;
  // the next chunk's carry, read now so that its latency hides behind the
  // copies and the two passes below (it is almost always there already)
  const bool waits = len > 0 && k + 1 < nchunks;
  unsigned next = waits ? load_relaxed(carry + chunk_elem + step) : 0u;
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  float* ca = sa + w * kBwdTD + lane;           // this thread's column
  float* ch = sh + w * kBwdTD + lane;           // row i + 1: step t0 + i
  float hp = len > 0 && k > 0 ? __ldg(states + chunk_elem - step) : 0.f;
  ch[0] = hp;
  __syncthreads();

  // 2. h_t over the chunk, as the forward computed it, over dBx in place
#pragma unroll 8
  for (int i = 0; i < kChunk; ++i) {
    hp = i < len ? fmaf(ca[i * kRow], hp, ch[(i + 1) * kRow]) : hp;
    ch[(i + 1) * kRow] = hp;
  }

  // 3. the chunk's map of the carry: P_k = A·P_{k+1} + bk (steps past
  // the end have gy = 0 and count as dA = 1)
  float A = 1.f, gl = 0.f, an = 0.f;
#pragma unroll 8
  for (int i = kChunk - 1; i >= 0; --i) {
    const float a = i < len ? ca[i * kRow] : 1.f;
    gl = fmaf(an, gl, sg[i * kBwdTD + lane] * sc[i * kBwdTN + w]);
    an = a;
    A *= a;
  }
  const float bk = an * gl;                     // an = dA at the first step

  // 4. P_{k+1} from the chunk after, then P_k for the chunk before
  float c = 0.f;
  if (waits) {
    while (next == kUnset) {
      __nanosleep(32);
      next = load_relaxed(carry + chunk_elem + step);
    }
    c = __uint_as_float(next);
  }
  if (len > 0 && k > 0) store_relaxed(carry + chunk_elem, fmaf(A, c, bk));

  // 5. the outputs, walking the chunk backwards from gh = P_{k+1}; each
  // step's gy·h_t goes into its dA slot, which the walk is done with
  const long long off = (b * S + t0) * step + elem;
  float* pga = g_dA + off;
  float* pgx = g_dBx + off;
  float gh = c;
  an = 1.f;
#pragma unroll 8
  for (int i = kChunk - 1; i >= 0; --i) {
    const float g = sg[i * kBwdTD + lane];
    gh = fmaf(an, gh, g * sc[i * kBwdTN + w]);
    an = ca[i * kRow];
    if (i < len) {
      pgx[i * step] = gh;
      pga[i * step] = gh * ch[i * kRow];          // h_{t−1}
    }
    ca[i * kRow] = g * ch[(i + 1) * kRow];        // gy_t · h_t
  }
  __syncwarp();

  // 6. the slice's Σ_d of gy·h for this warp's n: lane l sums steps l and
  // l + 32 over the 32 columns, from column l on (a fixed order, and the
  // lanes read 32 different banks)
  if (n < N) {
    float* pgc = g_Cpart + ((b * nslices + d0 / kBwdTD) * S + t0) * N + n;
    const float* q = sa + w * kBwdTD;
#pragma unroll
    for (int i = lane; i < kChunk; i += 32) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kBwdTD; ++j) s += q[i * kRow + ((lane + j) & 31)];
      if (i < steps) pgc[i * N] = s;
    }
  }
}

}  // namespace

extern "C" {

// The chunk length of the states and the backward's block tile, for the
// wrapper to size its buffers: chunk, Di columns, states n.
void repro_selective_scan_layout(int* chunk, int* bwd_td, int* bwd_tn) {
  *chunk = kChunk;
  *bwd_td = kBwdTD;
  *bwd_tn = kBwdTN;
}

// Launch on `stream`.  dA and dBx are contiguous (B, S, N, Di) float32, C
// (B, S, N), y (B, S, Di); `states`, when not null, (B, ⌈S/64⌉, N, Di)
// receives the hidden state at the end of every 64-step chunk.  Takes
// 1 ≤ N ≤ 32 and B ≤ 65535.  Returns the cudaError_t of the launch
// (0 = success).
int repro_selective_scan_f32(const void* dA, const void* dBx, const void* C,
                             int B, long long S, int N, int Di, void* y,
                             void* states, void* stream) {
  if (B <= 0 || S <= 0 || Di <= 0) return 0;
  if (N < 1 || N > 32 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((Di + kTD - 1) / kTD),
                  static_cast<unsigned>(B));
  const size_t smem = 2 * sizeof(float) * kT * N * kTD;
  const auto st = static_cast<cudaStream_t>(stream);
  if (states == nullptr) {
    selective_scan_kernel<<<grid, N * kTD, smem, st>>>(
        static_cast<const float*>(dA), static_cast<const float*>(dBx),
        static_cast<const float*>(C), S, N, Di, static_cast<float*>(y));
  } else {
    selective_scan_states_kernel<<<grid, N * kTD, smem, st>>>(
        static_cast<const float*>(dA), static_cast<const float*>(dBx),
        static_cast<const float*>(C), S, N, Di, static_cast<float*>(y),
        static_cast<float*>(states));
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward, on `stream`.  dA and dBx are contiguous (B, S, N, Di)
// float32, C (B, S, N), states (B, ⌈S/64⌉, N, Di) the forward's chunk
// states, gy (B, S, Di).  Writes g_dA and g_dBx (B, S, N, Di) and g_Cpart
// (B, ⌈Di/32⌉, S, N), the per-slice partial sums of g_C.  carry is
// (B, ⌈S/64⌉, N, Di) scratch with every 32-bit word 0xffffffff at launch;
// sync is one int32, zero at launch.  Takes 1 ≤ N ≤ 32 and fewer than
// 2^31 blocks.
// Returns the cudaError_t of the launch (0 = success).
int repro_selective_scan_bwd_f32(const void* dA, const void* dBx,
                                 const void* C, const void* states,
                                 const void* gy, int B, long long S, int N,
                                 int Di, void* g_dA, void* g_dBx,
                                 void* g_Cpart, void* carry, void* sync,
                                 void* stream) {
  if (B <= 0 || S <= 0 || Di <= 0) return 0;
  const long long nchunks = (S + kChunk - 1) / kChunk;
  const int nslices = (Di + kBwdTD - 1) / kBwdTD;
  const int ngroups = (N + kBwdTN - 1) / kBwdTN;
  const long long blocks = nchunks * B * nslices * ngroups;
  if (N < 1 || N > 32 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = Di % 4 == 0 ? selective_scan_bwd_kernel<16>
                                  : selective_scan_bwd_kernel<4>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<static_cast<unsigned>(blocks), 32 * kBwdTN, kBwdSmem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dA), static_cast<const float*>(dBx),
      static_cast<const float*>(C), static_cast<const float*>(states),
      static_cast<const float*>(gy), B, S, N, Di,
      static_cast<int>(nchunks), nslices, ngroups,
      static_cast<float*>(g_dA), static_cast<float*>(g_dBx),
      static_cast<float*>(g_Cpart), static_cast<float*>(carry),
      static_cast<int*>(sync));
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
