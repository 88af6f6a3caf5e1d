// Fused expand + LB1 + prune + compaction of a popped chunk of PFSP
// parents, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_kernel` of
// tpu_tree_search/ops/pallas_fused.py (entered through `fused_expand`):
// every child slot i of every parent b gets its LB1 bound; a child is a
// survivor when push = (i >= depth) & (b < n_valid) & (depth + 1 != J)
// & (lb < bound_cap), both n_valid and bound_cap read from device
// memory (so a CUDA graph that holds the launch reads them at each
// replay); survivors are stored compacted in the global column
// order c = (g*J + i)*TB + b (tiles, then slots, then parents: the order
// device._partition gives) into a frame of W columns, with the count
// n_surv exact even past W (stores stop there). Outputs per survivor: the
// child permutation (J int16), [child front | depth+1] (M+1 int32, or
// int16 with aux_i16), optionally its bound (int32) and its scheduled-set
// words (SW int32, bit v % 32 of word v / 32 for job v); and, with
// bins > 0, the histogram of the PRUNED non-leaf children's bounds in
// telemetry.bound_hist's bins (gap = |lb - max(cap, 1)|, bin
// min(gap * bins / ref, bins - 1), 64-bit). Pruned children never reach
// device memory. The frame is exactly W wide: the JAX kernel's store
// slack is a TPU artefact.
//
// What bounds it on this card (an H100 SXM: 3.35 TB/s, 16.7 T int32
// operations/s on the CUDA cores). At ta021's shape (chunk 65536, 20x20, TB
// 512, N = 1,310,720 child slots) the kernel reads about 8 MB of parents
// and writes, for the ~0.3 M survivors of a steady step, J*2 + (M+1)*4 +
// 4 = 128 bytes each, about 38 MB: 0.015 ms at 3.35 TB/s. Its int32 work,
// a remain sum of M per unscheduled job per parent and ~7*M per real
// child, is about 0.1 G operations: 0.006 ms. So bytes bound it.
//
// The first design (count pass, one-block scan, write pass, one thread per
// parent walking its J slots) took 0.158 ms there and 2.25-2.27 ms at
// ta091 (J = 200, TB 128: 32 blocks for 132 SMs), both on NVIDIA H100
// 80GB HBM3 at 700 W (device time, kernel_times.py): too few threads,
// every survivor bounded twice, and a scan that one block walked alone.
// This design:
//  1. prep (lb1_chain.cuh's prep_parents, shared with expand_bound.cu):
//     the parent's remain (M int32) and the scheduled-set words of its
//     prefix (SW) into scratch, computed once per parent instead of once
//     per child group, a long permutation split over several threads; it
//     also zeroes the look-back state and the histogram, so no memset is
//     needed.
//  2. main, a single pass with a chained scan and decoupled look-back.
//     A block owns a contiguous span of the global column order: one tile
//     g, K consecutive slots, all TB parents (K from the shape, so that
//     the grid holds hundreds of spans: 640 at ta021, 800 at ta091). Its
//     place in the order is an atomic ticket, not blockIdx, so a block
//     only ever waits on blocks that are already running. Each thread
//     bounds its R parents' children at the span's K slots once (parent
//     state loaded once per parent, the bound kept in shared memory when
//     it is an output), warp ballots of the push bits go to shared
//     memory, one warp scans their popcounts, publishes the block's
//     aggregate, and looks back over its predecessors' status words
//     (flag + aggregate or inclusive prefix, one 64-bit word each) until
//     it finds an inclusive prefix. Then each survivor is written at its
//     rank: the lanes of a warp stand at one slot together, so the
//     survivors' ranks there are consecutive and the stores coalesce. A
//     writing thread first copies its parent's permutation into its own
//     column of shared memory, with several loads in flight, instead of
//     reading it from device memory once per survivor. Only the child's
//     front chain, which the output holds, is run again at write time;
//     the bound is not recomputed.
// It takes 0.089 ms at ta021's shape and 0.172 ms at ta091's (device
// time, same card, kernel_times.py; its own pre-pass of one thread per
// parent took 0.086 and 0.187: the shared one splits a long permutation,
// and costs some 3 us more where the prefix words are asked for and one
// thread walks each parent, for reasons variants of it did not show). Of
// what is left, the first pass's loads of the parents' front and remain
// weigh most (variants timed without each part said so): 80 registers a
// thread hold a main block to 3 per SM, too few warps to hide their
// latency.
// The bound chain is lb1_chain.cuh's, shared with expand_bound.cu.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "lb1_chain.cuh"

namespace {

constexpr int kMaxBins = 64;
constexpr int kThreads = 256;    // most threads of a main block
constexpr int kSlots = 8;        // child slots a thread aims to hold
constexpr int kSpanFloor = 512;  // spans the grid aims to hold, at least
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

// The main kernel's layout, from the shape alone: BT threads a block, each
// holding R parents of its tile (bb = r*BT + thread) at K consecutive
// slots; NG slot groups per tile; G*NG blocks.
struct Geometry {
  int BT, R, K, NG, NW;
  long long blocks;
};

Geometry geometry(int J, int B, int TB) {
  Geometry q;
  q.BT = (TB + 31) / 32 * 32;
  if (q.BT > kThreads) q.BT = kThreads;
  q.R = (TB + q.BT - 1) / q.BT;
  const long long G = B / TB;
  long long k = kSlots / q.R;
  const long long spread = G * J / kSpanFloor;
  if (k > spread) k = spread;
  if (k > J) k = J;
  q.K = k < 1 ? 1 : (int)k;
  q.NG = (J + q.K - 1) / q.K;
  q.NW = q.BT / 32;
  q.blocks = G * q.NG;
  return q;
}

// int32 words of scratch a launch needs (see tts_fused_expand), or -1 for
// a shape the kernel does not take.
long long scratch_words(int B, int TB, int J, int M, int SW) {
  if (M < 1 || M > 32 || J < 1 || B < 1 || TB < 1 || B % TB != 0 || SW < 0)
    return -1;
  const Geometry q = geometry(J, B, TB);
  if (q.R > 32 || q.blocks >= INT_MAX) return -1;
  return 2 * (q.blocks + 1) + (long long)(M + SW) * B;
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* s) {
  return *(const volatile unsigned long long*)s;
}

__device__ __forceinline__ void store_status(unsigned long long* s,
                                             unsigned long long v) {
  *(volatile unsigned long long*)s = v;
}

// The parent pre-pass (lb1_chain.cuh's, shared with expand_bound.cu):
// remain (M, B) and prefix words (SW, B) into scratch; it also zeroes the
// status words, the ticket and the histogram.
template <int MAXM, int MC>
__global__ void fused_prep(const int* __restrict__ p,
                           const int16_t* __restrict__ prmu,
                           const int* __restrict__ depth, int J, int M,
                           int B, int SW, int bins, long long n_status,
                           unsigned long long* __restrict__ status,
                           int* __restrict__ rem_out,
                           unsigned* __restrict__ pre_out,
                           unsigned long long* __restrict__ hist) {
  extern __shared__ int smem[];
  const int nt = blockDim.x * blockDim.y;
  const long long gt = (long long)blockIdx.x * nt +
                       threadIdx.y * blockDim.x + threadIdx.x;
  const long long total = (long long)gridDim.x * nt;
  for (long long t = gt; t < n_status; t += total) status[t] = 0ull;
  for (long long t = gt; t < bins; t += total) hist[t] = 0ull;
  tts::prep_parents<MAXM>(smem, p, prmu, depth, J, MC ? MC : M, B, SW, true,
                          rem_out, pre_out);
}

template <int MAXM, int MC>
__global__ void __launch_bounds__(kThreads)
fused_main(const int* __restrict__ p, const int* __restrict__ tails,
           const int16_t* __restrict__ prmu, const int* __restrict__ depth,
           const int* __restrict__ front, const int* __restrict__ cap_ptr,
           const int* __restrict__ n_valid_ptr, int J, int M, int B, int TB,
           int W, int SW, int bins,
           int aux_i16, Geometry q, unsigned long long* __restrict__ status,
           const int* __restrict__ rem_in, const unsigned* __restrict__ pre_in,
           int16_t* __restrict__ children, void* __restrict__ caux,
           int* __restrict__ bounds, int* __restrict__ sched,
           int* __restrict__ n_surv, unsigned long long* __restrict__ hist) {
  extern __shared__ int smem[];
  const int Mx = MC ? MC : M;
  const int KRW = q.K * q.R * q.NW;
  int* sp = smem;                             // p, (M, J)
  int* st = sp + Mx * J;                      // min tails, (M,)
  int* sh = st + Mx;                          // pruned-bound histogram
  unsigned* sw = (unsigned*)(sh + bins);      // ballots, (K, R, NW)
  int* sbase = (int*)(sw + KRW);              // their bases in the span
  int* slb = sbase + KRW;                     // bounds, (K, R, BT)
  // each writing thread's parent permutation, (J, BT)
  int16_t* sperm = (int16_t*)(slb + (bounds ? q.K * q.R * q.BT : 0));
  __shared__ int s_ticket;
  __shared__ int s_base;
  // the popped count, read from device memory once a block; read from
  // shared memory at each use, so that it holds no register across the
  // bound loop (held in one, it tipped the generic M <= 16 instance into
  // spills)
  __shared__ int s_nvalid;
  const int tid = threadIdx.x;
  for (int t = tid; t < Mx * J; t += blockDim.x) sp[t] = p[t];
  for (int t = tid; t < Mx; t += blockDim.x) st[t] = tails[t];
  for (int t = tid; t < bins; t += blockDim.x) sh[t] = 0;
  if (tid == 0) {
    s_ticket = (int)atomicAdd((unsigned*)(status + q.blocks), 1u);
    s_nvalid = *n_valid_ptr;
  }
  __syncthreads();

  const int s = s_ticket;
  const int g = s / q.NG;
  const int i0 = (s - g * q.NG) * q.K;
  const int kk = min(q.K, J - i0);
  const int cap = *cap_ptr;
  const long long ref = max((long long)cap, 1LL);
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // bound every child slot of the span once; push bits as warp ballots
  for (int r = 0; r < q.R; ++r) {
    const int bb = r * q.BT + tid;
    const int b = g * TB + bb;
    const bool in_tile = bb < TB;
    const int d = in_tile ? depth[b] : 0;
    // leaves (depth + 1 == J) belong to the caller's parent-level scan
    const bool need =
        in_tile && b < *(volatile int*)&s_nvalid && d + 1 < J && i0 + kk > d;
    int fr[MAXM], rem[MAXM];
#pragma unroll
    for (int k = 0; k < MAXM; ++k) {
      fr[k] = (need && k < Mx) ? front[(long long)k * B + b] : 0;
      rem[k] = (need && k < Mx) ? rem_in[(long long)k * B + b] : 0;
    }
    for (int kq = 0; kq < kk; ++kq) {
      const int i = i0 + kq;
      bool push = false;
      if (need && i >= d) {
        const int lb = tts::child_bound<MAXM>(
            sp, st, fr, rem, Mx, J,
            tts::job_index(prmu[(long long)i * B + b], J), 1,
            [](int, int) {});
        push = lb < cap;
        if (!push && bins) {
          const long long gap = llabs((long long)lb - ref);
          atomicAdd(&sh[(int)min(gap * bins / ref, (long long)bins - 1)], 1);
        }
        if (bounds) slb[(kq * q.R + r) * q.BT + tid] = lb;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, push);
      if (lane == 0) sw[(kq * q.R + r) * q.NW + warp] = ballot;
    }
  }
  __syncthreads();
  if (bins)
    for (int t = tid; t < bins; t += blockDim.x)
      if (sh[t]) atomicAdd(&hist[t], (unsigned long long)sh[t]);

  if (warp == 0) {
    // the span's exclusive bases, in column order, and its aggregate
    const int n_words = kk * q.R * q.NW;
    int agg = 0;
    for (int w0 = 0; w0 < n_words; w0 += 32) {
      const int w = w0 + lane;
      const int c = w < n_words ? __popc(sw[w]) : 0;
      const int x = warp_inclusive_sum(c, lane);
      if (w < n_words) sbase[w] = agg + x - c;
      agg += __shfl_sync(0xffffffffu, x, 31);
    }
    // decoupled look-back: sum predecessors' aggregates back to the
    // nearest inclusive prefix
    int excl = 0;
    if (s == 0) {
      if (lane == 0) store_status(status, kPrefix | (unsigned)agg);
    } else {
      if (lane == 0) store_status(status + s, kAggregate | (unsigned)agg);
      int at = s - 1;
      while (true) {
        const int j = at - lane;
        const unsigned long long v =
            j >= 0 ? load_status(status + j) : kPrefix;
        const unsigned flag = (unsigned)(v >> 32);
        const unsigned pre = __ballot_sync(0xffffffffu, flag == 2u);
        const unsigned unset = __ballot_sync(0xffffffffu, flag == 0u);
        // lanes up to the nearest inclusive prefix are the ones needed
        const unsigned needed =
            pre ? (pre ^ (pre - 1u)) : 0xffffffffu;
        if (unset & needed) {
          __nanosleep(64);
          continue;
        }
        const int part = ((needed >> lane) & 1u) ? (int)(unsigned)v : 0;
        excl += __reduce_add_sync(0xffffffffu, part);
        if (pre) break;
        at -= 32;
      }
      if (lane == 0)
        store_status(status + s, kPrefix | (unsigned)(excl + agg));
    }
    if (lane == 0) {
      s_base = excl;
      if (s == q.blocks - 1) *n_surv = excl + agg;
    }
  }
  __syncthreads();

  // write every survivor at its rank (stores stop at W)
  const int base = s_base;
  const unsigned below = (1u << lane) - 1u;
  int16_t* caux16 = (int16_t*)caux;
  int* caux32 = (int*)caux;
  for (int r = 0; r < q.R; ++r) {
    bool mine = false;
    for (int kq = 0; kq < kk; ++kq)
      mine |= (sw[(kq * q.R + r) * q.NW + warp] >> lane) & 1u;
    if (!mine) continue;
    const int b = g * TB + r * q.BT + tid;
    const int d = depth[b];
    // the parent's permutation, read once into this thread's column of
    // shared memory with several loads in flight, then read per survivor
    int16_t* perm = sperm + tid;
#pragma unroll 8
    for (int pos = 0; pos < J; ++pos)
      perm[pos * q.BT] = prmu[(long long)pos * B + b];
    const int jd = perm[max(d, 0) * q.BT];
    int fr[MAXM];
#pragma unroll
    for (int k = 0; k < MAXM; ++k)
      fr[k] = k < Mx ? front[(long long)k * B + b] : 0;
    for (int kq = 0; kq < kk; ++kq) {
      const int wi = (kq * q.R + r) * q.NW + warp;
      const unsigned word = sw[wi];
      if (!((word >> lane) & 1u)) continue;
      const long long rk = (long long)base + sbase[wi] + __popc(word & below);
      if (rk >= W) continue;
      const int i = i0 + kq;
      const int jv = perm[i * q.BT];
      // only the front chain survives dead-code elimination here: the
      // bound is discarded (it came from the first pass)
      tts::child_bound<MAXM>(
          sp, st, fr, fr, Mx, J, tts::job_index(jv, J), 1,
          [&](int k, int cf) {
            if (aux_i16)
              caux16[(long long)k * W + rk] = (int16_t)cf;
            else
              caux32[(long long)k * W + rk] = cf;
          });
      if (aux_i16)
        caux16[(long long)Mx * W + rk] = (int16_t)(d + 1);
      else
        caux32[(long long)Mx * W + rk] = d + 1;
      if (bounds) bounds[rk] = slb[(kq * q.R + r) * q.BT + tid];
      for (int pos = 0; pos < J; ++pos) {
        const int16_t v = pos == d ? (int16_t)jv
                          : pos == i ? (int16_t)jd
                                     : perm[pos * q.BT];
        children[(long long)pos * W + rk] = v;
      }
      for (int w = 0; w < SW; ++w) {
        unsigned bits = pre_in[(long long)w * B + b];
        if (jv >= 32 * w && jv < 32 * (w + 1)) bits |= 1u << (jv - 32 * w);
        sched[(long long)w * W + rk] = (int)bits;  // bit 31 becomes the sign
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int MAXM, int MC>
cudaError_t launch(const int* p, const int* tails, const int16_t* prmu,
                   const int* depth, const int* front, const int* cap,
                   const int* n_valid, int J, int M, int B, int TB, int W,
                   int SW, int bins, int aux_i16, int16_t* children,
                   void* caux,
                   int* bounds, int* sched, int* n_surv,
                   unsigned long long* hist, const Geometry& q,
                   unsigned long long* status, int* rem, unsigned* pre,
                   cudaStream_t s) {
  const int S = tts::prep_splits(J, B), PX = tts::kPrepThreads / S;
  const size_t smem_prep =
      sizeof(int) * tts::prep_smem_words(J, M, SW, S);
  const size_t krw = (size_t)q.K * q.R * q.NW;
  const size_t smem_main =
      sizeof(int) * ((size_t)M * J + M + bins + 2 * krw +
                     (bounds ? (size_t)q.K * q.R * q.BT : 0)) +
      sizeof(int16_t) * (size_t)J * q.BT;
  cudaError_t e = allow_smem(fused_prep<MAXM, MC>, smem_prep);
  if (e == cudaSuccess) e = allow_smem(fused_main<MAXM, MC>, smem_main);
  if (e != cudaSuccess) return e;
  fused_prep<MAXM, MC><<<(B + PX - 1) / PX, dim3(PX, S), smem_prep, s>>>(
      p, prmu, depth, J, M, B, SW, bins, q.blocks + 1, status, rem, pre,
      hist);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fused_main<MAXM, MC><<<(unsigned)q.blocks, q.BT, smem_main, s>>>(
      p, tails, prmu, depth, front, cap, n_valid, J, M, B, TB, W, SW, bins,
      aux_i16, q, status, rem, pre, children, caux, bounds, sched, n_surv,
      hist);
  return cudaGetLastError();
}

}  // namespace

// p (M, J) int32; tails (M,) int32; prmu (J, B) int16; depth (B,) int32;
// front (M, B) int32; cap and n_valid: one int32 each on the device
// (n_valid clamped to [0, B]); all contiguous.
// Outputs: children (J, W) int16; caux (M+1, W) int32, or int16 when
// aux_i16 != 0; bounds (W,) int32 or null; sched (SW, W) int32 or null
// (SW = 0); n_surv: one int32; hist (bins,) int64 or null (bins = 0).
// scratch, in int32 words: 2 * (blocks + 1) for the 64-bit status words
// of the look-back (one per block, then the ticket counter), then the
// parents' remain (M * B), then their prefix scheduled-set words (SW * B).
// blocks = (B / TB) * NG from `geometry`: BT = min(256, TB rounded up to
// 32), R = ceil(TB / BT), K = max(1, min(8 / R, (B / TB) * J / 512, J)),
// NG = ceil(J / K); tts_fused_scratch_words gives the total. B must be a
// multiple of TB, 1 <= M <= 32, bins <= 64, R <= 32.
// Returns the first CUDA error of the two launches, or 0.
extern "C" long long tts_fused_scratch_words(int B, int TB, int J, int M,
                                             int SW) {
  return scratch_words(B, TB, J, M, SW);
}

extern "C" int tts_fused_expand(const void* p, const void* tails,
                                const void* prmu, const void* depth,
                                const void* front, const void* cap,
                                const void* n_valid, int J, int M, int B,
                                int TB, int W, int SW, int bins, int aux_i16,
                                void* children, void* caux, void* bounds,
                                void* sched, void* n_surv, void* hist,
                                void* scratch, long long scratch_len,
                                void* stream) {
  const long long need = scratch_words(B, TB, J, M, SW);
  if (need < 0 || scratch_len < need || W < 1 || bins < 0 ||
      bins > kMaxBins || (SW > 0) != (sched != nullptr) ||
      (bins > 0) != (hist != nullptr))
    return (int)cudaErrorInvalidValue;
  const Geometry q = geometry(J, B, TB);
  auto s = (cudaStream_t)stream;
  auto status = (unsigned long long*)scratch;
  auto rem = (int*)(status + q.blocks + 1);
  auto pre = (unsigned*)(rem + (long long)M * B);
  auto args = [&](auto fn) {
    return fn((const int*)p, (const int*)tails, (const int16_t*)prmu,
              (const int*)depth, (const int*)front, (const int*)cap,
              (const int*)n_valid, J, M, B, TB, W, SW, bins, aux_i16,
              (int16_t*)children, caux,
              (int*)bounds, (int*)sched, (int*)n_surv,
              (unsigned long long*)hist, q, status, rem, pre, s);
  };
  // the Taillard machine counts get instances with M fixed at compile time:
  // at ta021, ta007 and ta091 they ran 1.41x, 1.23x and 1.64x faster than
  // the generic instances (kernel_times.py --generic-m, H100)
  if (M == 5) return (int)args(launch<5, 5>);
  if (M == 10) return (int)args(launch<10, 10>);
  if (M == 20) return (int)args(launch<20, 20>);
  if (M <= 8) return (int)args(launch<8, 0>);
  if (M <= 16) return (int)args(launch<16, 0>);
  return (int)args(launch<32, 0>);
}
