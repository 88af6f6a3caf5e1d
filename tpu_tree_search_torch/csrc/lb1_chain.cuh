// The per-parent pre-pass and the per-child bound math shared by
// expand_bound.cu and fused_expand.cu, so that the two kernels cannot
// drift apart: the parent's remain and prefix scheduled-set words, and one
// child's front chain and LB1 / LB1_d bound. All of it is exact int32
// arithmetic (the TPU kernels' f32 one-hot matmuls are exact below 2^24,
// so the values are equal).
#pragma once

#include <cstddef>
#include <cstdint>

namespace tts {

// Job id of a permutation entry, clamped into [0, J) so that a garbage
// column (a parent past the popped count) never indexes out of p.
__device__ __forceinline__ int job_index(int v, int J) {
  return min(max(v, 0), J - 1);
}

// The pre-pass's block: PX parents by S position splits, kPrepThreads in
// all. Thread (x, s) walks positions s, s + S, s + 2S, ... of parent
// blockIdx.x * PX + x, so its loads coalesce along the parents. S grows
// while a thread would walk more than kPrepWalk positions, or the grid
// would hold fewer than kPrepSpread threads (one thread per parent left a
// chunk of 4096 parents with one warp per SM, each walking J positions
// with a load's latency at each).
constexpr int kPrepThreads = 128;
constexpr long long kPrepSpread = 65536;
constexpr int kPrepWalk = 24;

inline int prep_splits(int J, int B) {
  int S = 1;
  while (S < 8 && 2 * S <= J &&
         ((long long)B * S < kPrepSpread || J > kPrepWalk * S))
    S *= 2;
  return S;
}

// int32 words of shared memory a pre-pass block needs: p (M, J), then
// the partial sums (S, M + SW, PX), of which one split (S = 1) uses only
// its words.
inline size_t prep_smem_words(int J, int M, int SW, int S) {
  return (size_t)M * J + (size_t)(S > 1 ? M + SW : SW) * kPrepThreads;
}

// The pre-pass, for blockDim = (kPrepThreads / S, S): with `remain`
// every parent b's remain, the unscheduled work per machine summed over
// positions [d, J) of its permutation, into rem_out (M, B); and with
// SW > 0 the scheduled-set words of its prefix [0, d) into pre_out
// (SW, B), bit v % 32 of word v / 32 for job v. The words are sums of
// those bits, as the JAX package's sched_mask_cols takes them (an OR for
// a permutation; a garbage column with a repeated job wraps the same way
// there and here). smem holds prep_smem_words(J, M, SW, S) words.
template <int MAXM>
__device__ __forceinline__ void prep_parents(
    int* smem, const int* __restrict__ p, const int16_t* __restrict__ prmu,
    const int* __restrict__ depth, int J, int M, int B, int SW, bool remain,
    int* __restrict__ rem_out, unsigned* __restrict__ pre_out) {
  const int PX = blockDim.x, S = blockDim.y;
  const int x = threadIdx.x, s = threadIdx.y;
  const int R = M + SW;
  int* sp = smem;                       // p, (M, J)
  // partial sums, (S, R, PX); one split keeps only its words there
  unsigned* part = (unsigned*)(sp + M * J);
  for (int t = s * PX + x; t < M * J; t += PX * S) sp[t] = p[t];
  __syncthreads();
  const int b = blockIdx.x * PX + x;
  const bool live = b < B;
  const int d = live ? depth[b] : 0;
  // my SW words, PX apart
  unsigned* mine = part + (S > 1 ? (s * R + M) * PX : 0) + x;
  for (int w = 0; w < SW; ++w) mine[w * PX] = 0u;
  unsigned w0 = 0u, w1 = 0u;  // the words themselves when SW <= 2
  int rem[MAXM];
#pragma unroll
  for (int k = 0; k < MAXM; ++k) rem[k] = 0;
  if (live) {
    // remain: the positions of [d, J) that are this split's
    int pos = d > s ? s + (d - s + S - 1) / S * S : s;
#pragma unroll 4
    for (; remain && pos < J; pos += S) {
      const int job = job_index(prmu[(long long)pos * B + b], J);
#pragma unroll
      for (int k = 0; k < MAXM; ++k)
        if (k < M) rem[k] += sp[k * J + job];
    }
    // the prefix words: the positions of [0, d) that are this split's
    for (pos = s; SW && pos < d && pos < J; pos += S) {
      const int v = prmu[(long long)pos * B + b];
      if (v < 0 || v >= 32 * SW) continue;
      const unsigned bit = 1u << (v & 31);
      if (SW > 2) {
        mine[(v >> 5) * PX] += bit;
      } else {
        w0 += v < 32 ? bit : 0u;
        w1 += v < 32 ? 0u : bit;
      }
    }
  }
  if (SW == 1 || SW == 2) {
    mine[0] = w0;
    if (SW == 2) mine[PX] = w1;
  }
  if (S == 1) {  // nothing to add up: no round trip through part
    if (!live) return;
#pragma unroll
    for (int k = 0; k < MAXM; ++k)
      if (remain && k < M) rem_out[(long long)k * B + b] = rem[k];
    for (int w = 0; w < SW; ++w) pre_out[(long long)w * B + b] = mine[w * PX];
    return;
  }
#pragma unroll
  for (int k = 0; k < MAXM; ++k)
    if (k < M) part[(s * R + k) * PX + x] = (unsigned)rem[k];
  __syncthreads();
  if (!live) return;
  for (int r = remain ? s : M + s; r < R; r += S) {
    unsigned acc = 0u;
    for (int q = 0; q < S; ++q) acc += part[(q * R + r) * PX + x];
    if (r < M)
      rem_out[(long long)r * B + b] = (int)acc;
    else
      pre_out[(long long)(r - M) * B + b] = acc;
  }
}

// Appends `job` to a parent with front fr and remain rem: calls
// on_front(k, cf) with the child's front on each machine k, and returns
// the child's LB1 (lb_kind 1: machine_bound_from_parts on the child,
// c_bound_simple.c:126-141) or LB1_d (lb_kind 0: add_front_and_bound from
// the parent, c_bound_simple.c:218-244). st holds the min tails (M,).
template <int MAXM, typename OnFront>
__device__ __forceinline__ int child_bound(const int* sp, const int* st,
                                           const int (&fr)[MAXM],
                                           const int (&rem)[MAXM], int M,
                                           int J, int job, int lb_kind,
                                           OnFront on_front) {
  int c = sp[job];
  int cf = fr[0] + c;
  on_front(0, cf);
  int tmp0, lb;
  if (lb_kind == 1) {
    tmp0 = cf + (rem[0] - c);
    lb = tmp0 + st[0];
  } else {
    lb = fr[0] + rem[0] + st[0];
    tmp0 = fr[0] + c;
  }
#pragma unroll
  for (int k = 1; k < MAXM; ++k) {
    if (k < M) {
      c = sp[k * J + job];
      cf = max(cf, fr[k]) + c;
      on_front(k, cf);
      if (lb_kind == 1) {
        const int tmp1 = max(tmp0, cf + (rem[k] - c));
        lb = max(lb, tmp1 + st[k]);
        tmp0 = tmp1;
      } else {
        const int tmp1 = max(tmp0, fr[k]);
        lb = max(lb, tmp1 + rem[k] + st[k]);
        tmp0 = tmp1 + c;
      }
    }
  }
  return lb;
}

}  // namespace tts
