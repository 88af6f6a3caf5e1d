// Fused expand + LB1 + prune + compaction of a popped chunk of PFSP
// parents, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_kernel` of
// tpu_tree_search/ops/pallas_fused.py (entered through `fused_expand`):
// every child slot i of every parent b gets its LB1 bound; a child is a
// survivor when push = (i >= depth) & (b < n_valid) & (depth + 1 != J)
// & (lb < bound_cap); survivors are stored compacted in the global column
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
// (prmu J*2, front M*4, depth 4 bytes each) and writes, for the ~0.3 M
// survivors of a steady step, J*2 + (M+1)*4 + 4 = 128 bytes each, about
// 38 MB: 0.014 ms at 3.35 TB/s. Its int32 work is the bounds-only
// kernel's, about 0.1 G operations (a remain sum of M per unscheduled job
// per parent, ~7*M per real child): 0.006 ms at the CUDA cores' int32
// rate. So the survivor block's bytes bound it; the bound math has slack
// and is paid twice here.
//
// Design: three launches on one stream, no host round trip.
//  1. count: one thread per parent, blocks of BT <= 128 parents of one
//     tile. Each thread walks the J slots in lockstep with its warp,
//     bounds its child, and the warp's push bits go out as one
//     __ballot_sync word per (tile, slot, sub-block, warp): words in
//     global column order. Pruned non-leaf children are binned into a
//     shared-memory histogram, flushed with one 64-bit atomic per bin.
//  2. scan: one block turns the words' popcounts into an exclusive prefix
//     (each survivor's rank is its word's base plus the popcount of the
//     lower lanes) and writes n_surv.
//  3. write: the same thread layout recomputes only the survivors (its
//     bit set, rank < W) and stores them at their rank; the lanes of a
//     warp walk the slots together, and the ranks of a warp's survivors
//     at one slot are consecutive, so the stores coalesce.
// The bound chain is lb1_chain.cuh's, shared with expand_bound.cu. A
// single-pass decoupled look-back would drop the recomputation and the
// scan launch; that is later work.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "lb1_chain.cuh"

namespace {

constexpr int kMaxBins = 64;
constexpr int kScanThreads = 1024;

// word index of (tile g, slot i, sub-block sb, warp w): global order
__device__ __forceinline__ long long word_at(int g, int i, int sb, int w,
                                             int J, int NSB, int NW) {
  return (((long long)g * J + i) * NSB + sb) * NW + w;
}

template <int MAXM>
__global__ void fused_count(const int* __restrict__ p,
                            const int* __restrict__ tails,
                            const int16_t* __restrict__ prmu,
                            const int* __restrict__ depth,
                            const int* __restrict__ front,
                            const int* __restrict__ cap_ptr, int J, int M,
                            int B, int TB, int NSB, int n_valid, int bins,
                            unsigned* __restrict__ words,
                            unsigned long long* __restrict__ hist) {
  extern __shared__ int smem[];
  int* sp = smem;              // p, (M, J) row-major
  int* st = sp + M * J;        // min tails, (M,)
  int* sh = st + M;            // pruned-bound histogram, (bins,)
  for (int t = threadIdx.x; t < M * J; t += blockDim.x) sp[t] = p[t];
  for (int t = threadIdx.x; t < M; t += blockDim.x) st[t] = tails[t];
  for (int t = threadIdx.x; t < bins; t += blockDim.x) sh[t] = 0;
  __syncthreads();

  const int g = blockIdx.x / NSB;
  const int sb = blockIdx.x - g * NSB;
  const int bb = sb * blockDim.x + threadIdx.x;
  const int b = g * TB + bb;
  const bool in_tile = bb < TB;
  const int d = in_tile ? depth[b] : 0;
  // leaves (depth + 1 == J) belong to the caller's parent-level scan
  const bool branches = in_tile && b < n_valid && d + 1 < J;
  const int cap = *cap_ptr;
  const long long ref = max((long long)cap, 1LL);
  const int NW = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int fr[MAXM], rem[MAXM];
  tts::parent_state<MAXM>(sp, prmu, front, J, M, B, in_tile ? b : 0, d, fr,
                          rem);
  for (int i = 0; i < J; ++i) {
    bool push = false;
    if (branches && i >= d) {
      const int lb = tts::child_bound<MAXM>(
          sp, st, fr, rem, M, J, tts::job_index(prmu[(long long)i * B + b], J),
          1, [](int, int) {});
      push = lb < cap;
      if (!push && bins) {
        const long long gap = llabs((long long)lb - ref);
        atomicAdd(&sh[(int)min(gap * bins / ref, (long long)bins - 1)], 1);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, push);
    if (lane == 0) words[word_at(g, i, sb, warp, J, NSB, NW)] = ballot;
  }
  if (bins) {
    __syncthreads();
    for (int t = threadIdx.x; t < bins; t += blockDim.x)
      if (sh[t]) atomicAdd(&hist[t], (unsigned long long)sh[t]);
  }
}

// One block: bases[k] = survivors in words [0, k); *n_surv = all of them.
// The block walks the words in chunks of kScanPer per thread, neighbouring
// threads on neighbouring words (coalesced), with a running carry.
constexpr int kScanPer = 4;

__global__ void fused_scan(const unsigned* __restrict__ words, int n_words,
                           int* __restrict__ bases, int* __restrict__ n_surv) {
  __shared__ int warp_sum[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int carry = 0;
  for (int start = 0; start < n_words; start += blockDim.x * kScanPer) {
    const int k0 = start + threadIdx.x * kScanPer;
    int cnt[kScanPer];
    int own = 0;
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      cnt[j] = k0 + j < n_words ? __popc(words[k0 + j]) : 0;
      own += cnt[j];
    }
    int x = own;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int v = lane < n_warps ? warp_sum[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += y;
      }
      warp_sum[lane] = v;
    }
    __syncthreads();
    int base = carry + x - own + (warp ? warp_sum[warp - 1] : 0);
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      if (k0 + j < n_words) bases[k0 + j] = base;
      base += cnt[j];
    }
    carry += warp_sum[n_warps - 1];
    __syncthreads();  // warp_sum is rewritten by the next chunk
  }
  if (threadIdx.x == 0) *n_surv = carry;
}

template <int MAXM>
__global__ void fused_write(const int* __restrict__ p,
                            const int* __restrict__ tails,
                            const int16_t* __restrict__ prmu,
                            const int* __restrict__ depth,
                            const int* __restrict__ front, int J, int M,
                            int B, int TB, int NSB, int n_valid, int W,
                            int SW, int aux_i16,
                            const unsigned* __restrict__ words,
                            const int* __restrict__ bases,
                            int16_t* __restrict__ children,
                            void* __restrict__ caux,
                            int* __restrict__ bounds,
                            int* __restrict__ sched) {
  extern __shared__ int smem[];
  int* sp = smem;                                  // p, (M, J)
  int* st = sp + M * J;                            // min tails, (M,)
  unsigned* pre = (unsigned*)(st + M);             // prefix words (SW, BT)
  for (int t = threadIdx.x; t < M * J; t += blockDim.x) sp[t] = p[t];
  for (int t = threadIdx.x; t < M; t += blockDim.x) st[t] = tails[t];
  __syncthreads();

  const int g = blockIdx.x / NSB;
  const int sb = blockIdx.x - g * NSB;
  const int bb = sb * blockDim.x + threadIdx.x;
  const int b = g * TB + bb;
  if (bb >= TB || b >= n_valid) return;
  const int d = depth[b];
  if (d < 0 || d + 1 >= J) return;
  const int NW = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;

  int fr[MAXM], rem[MAXM];
  tts::parent_state<MAXM>(sp, prmu, front, J, M, B, b, d, fr, rem);
  // the parent's scheduled-set words, in this thread's shared column
  unsigned* mine = pre + threadIdx.x;
  for (int w = 0; w < SW; ++w) mine[w * blockDim.x] = 0u;
  for (int pos = 0; pos < d; ++pos) {
    const int v = prmu[(long long)pos * B + b];
    if (v >= 0 && v < 32 * SW) mine[(v >> 5) * blockDim.x] |= 1u << (v & 31);
  }
  const int jd = prmu[(long long)d * B + b];
  int16_t* caux16 = (int16_t*)caux;
  int* caux32 = (int*)caux;

  // every lane walks all J slots, so a warp's lanes stand at the same slot
  // together: one word load for the warp, and its survivors there hold
  // consecutive ranks, so their stores coalesce
  for (int i = 0; i < J; ++i) {
    const long long wi = word_at(g, i, sb, warp, J, NSB, NW);
    const unsigned word = words[wi];
    if (!((word >> lane) & 1u)) continue;
    const long long r = (long long)bases[wi] + __popc(word & below);
    if (r >= W) continue;
    const int jv = prmu[(long long)i * B + b];
    const int lb = tts::child_bound<MAXM>(
        sp, st, fr, rem, M, J, tts::job_index(jv, J), 1,
        [&](int k, int cf) {
          if (aux_i16)
            caux16[(long long)k * W + r] = (int16_t)cf;
          else
            caux32[(long long)k * W + r] = cf;
        });
    if (aux_i16)
      caux16[(long long)M * W + r] = (int16_t)(d + 1);
    else
      caux32[(long long)M * W + r] = d + 1;
    if (bounds) bounds[r] = lb;
    for (int pos = 0; pos < J; ++pos) {
      const int16_t v = pos == d ? (int16_t)jv
                        : pos == i ? (int16_t)jd
                                   : prmu[(long long)pos * B + b];
      children[(long long)pos * W + r] = v;
    }
    for (int w = 0; w < SW; ++w) {
      unsigned bits = mine[w * blockDim.x];
      if (jv >= 32 * w && jv < 32 * (w + 1)) bits |= 1u << (jv - 32 * w);
      sched[(long long)w * W + r] = (int)bits;  // bit 31 becomes the sign
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int MAXM>
cudaError_t launch(const int* p, const int* tails, const int16_t* prmu,
                   const int* depth, const int* front, const int* cap, int J,
                   int M, int B, int TB, int n_valid, int W, int SW,
                   int bins, int aux_i16, int16_t* children, void* caux,
                   int* bounds, int* sched, int* n_surv,
                   unsigned long long* hist, unsigned* words, int* bases,
                   int BT, int NSB, int n_words, cudaStream_t s) {
  const int blocks = (B / TB) * NSB;
  const size_t smem_count = sizeof(int) * (size_t)(M * J + M + bins);
  const size_t smem_write = sizeof(int) * (size_t)(M * J + M + SW * BT);
  cudaError_t e = allow_smem(fused_count<MAXM>, smem_count);
  if (e == cudaSuccess) e = allow_smem(fused_write<MAXM>, smem_write);
  if (e == cudaSuccess && bins)
    e = cudaMemsetAsync(hist, 0, sizeof(unsigned long long) * bins, s);
  if (e != cudaSuccess) return e;
  fused_count<MAXM><<<blocks, BT, smem_count, s>>>(
      p, tails, prmu, depth, front, cap, J, M, B, TB, NSB, n_valid, bins,
      words, hist);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fused_scan<<<1, kScanThreads, 0, s>>>(words, n_words, bases, n_surv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fused_write<MAXM><<<blocks, BT, smem_write, s>>>(
      p, tails, prmu, depth, front, J, M, B, TB, NSB, n_valid, W, SW,
      aux_i16, words, bases, children, caux, bounds, sched);
  return cudaGetLastError();
}

}  // namespace

// p (M, J) int32; tails (M,) int32; prmu (J, B) int16; depth (B,) int32;
// front (M, B) int32; cap: one int32 on the device; all contiguous.
// Outputs: children (J, W) int16; caux (M+1, W) int32, or int16 when
// aux_i16 != 0; bounds (W,) int32 or null; sched (SW, W) int32 or null
// (SW = 0); n_surv: one int32; hist (bins,) int64 or null (bins = 0).
// scratch: 2 * n_words int32 for the ballot words and their bases, with
// BT = min(128, TB rounded up to 32), NSB = ceil(TB / BT) and
// n_words = (B / TB) * J * NSB * BT / 32 (ops/kernels.py computes the
// same). B must be a multiple of TB, 1 <= M <= 32, bins <= 64.
// Returns the first CUDA error of the three launches, or 0.
extern "C" int tts_fused_expand(const void* p, const void* tails,
                                const void* prmu, const void* depth,
                                const void* front, const void* cap, int J,
                                int M, int B, int TB, int n_valid, int W,
                                int SW, int bins, int aux_i16,
                                void* children, void* caux, void* bounds,
                                void* sched, void* n_surv, void* hist,
                                void* scratch, long long scratch_words,
                                void* stream) {
  if (M < 1 || M > 32 || J < 1 || B < 1 || TB < 1 || B % TB != 0 || W < 1 ||
      bins < 0 || bins > kMaxBins || SW < 0 ||
      (SW > 0) != (sched != nullptr) || (bins > 0) != (hist != nullptr))
    return (int)cudaErrorInvalidValue;
  const int BT = min(128, (TB + 31) / 32 * 32);
  const int NSB = (TB + BT - 1) / BT;
  const long long n_words = (long long)(B / TB) * J * NSB * (BT / 32);
  if (n_words > INT_MAX / 2 || scratch_words < 2 * n_words)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto words = (unsigned*)scratch;
  auto bases = (int*)scratch + n_words;
  auto args = [&](auto fn) {
    return fn((const int*)p, (const int*)tails, (const int16_t*)prmu,
              (const int*)depth, (const int*)front, (const int*)cap, J, M, B,
              TB, n_valid, W, SW, bins, aux_i16, (int16_t*)children, caux,
              (int*)bounds, (int*)sched, (int*)n_surv,
              (unsigned long long*)hist, words, bases, BT, NSB,
              (int)n_words, s);
  };
  if (M <= 8) return (int)args(launch<8>);
  if (M <= 16) return (int)args(launch<16>);
  return (int)args(launch<32>);
}
