// The per-child bound math shared by expand_bound.cu and fused_expand.cu,
// so that the two kernels cannot drift apart: the parent's front and
// remain, and one child's front chain and LB1 / LB1_d bound. All of it is
// exact int32 arithmetic (the TPU kernels' f32 one-hot matmuls are exact
// below 2^24, so the values are equal).
#pragma once

#include <cstdint>

namespace tts {

// Job id of a permutation entry, clamped into [0, J) so that a garbage
// column (a parent past the popped count) never indexes out of p.
__device__ __forceinline__ int job_index(int v, int J) {
  return min(max(v, 0), J - 1);
}

// Parent b's front (M values of front (M, B)) and remain: the unscheduled
// work per machine, summed over positions [d, J) of its permutation.
// sp is p (M, J) row-major in shared memory.
template <int MAXM>
__device__ __forceinline__ void parent_state(
    const int* sp, const int16_t* __restrict__ prmu,
    const int* __restrict__ front, int J, int M, int B, int b, int d,
    int (&fr)[MAXM], int (&rem)[MAXM]) {
#pragma unroll
  for (int k = 0; k < MAXM; ++k) {
    fr[k] = k < M ? front[(long long)k * B + b] : 0;
    rem[k] = 0;
  }
  for (int i = max(d, 0); i < J; ++i) {
    const int job = job_index(prmu[(long long)i * B + b], J);
#pragma unroll
    for (int k = 0; k < MAXM; ++k)
      if (k < M) rem[k] += sp[k * J + job];
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
