// Johnson two-machine LB2 sweep over child columns, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_lb2_kernel` (J <= 64) and `_lb2_bigj_kernel`
// (J > 64) of tpu_tree_search/ops/pallas_expand.py; both compute `lb2_cols`
// of that file. For each child column and each machine pair: seed t0/t1
// from the child front on the pair's two machines, run the J-step chain
// over the pair's Johnson order, advancing only on jobs the child has not
// scheduled (t0 += pt0; t1 = max(t1, t0 + lag) + pt1), then take
// max(t1 + tail[ma1], t0 + tail[ma0]); the bound is the max over pairs.
// There is no early exit (c_bound_johnson.c:231-233 has one): the values
// of pruned children stay exact.
//
// What bounds it on this card: integer operations. A column reads M*4 +
// W*4 bytes and writes 4, but does P*J chain steps of ~8 int32
// operations each (190 pairs x 20 jobs at 20x20).
//
// Design: one thread per child column, its scheduled-set words (W =
// ceil(J/32) uint32, the bitmask the engine already builds; the (J, N)
// 0/1 plane the TPU built for its matrix unit is never made) in
// registers. The per-step pair tables are packed as int4 {job, pt0, pt1,
// lag} and staged in shared memory a block of pairs at a time, so every
// step is one broadcast 16-byte shared load. The two machines' fronts are
// read per pair from device memory, coalesced across the warp. The
// active test is a select, not a branch, so the warp never diverges.
// Hopper has no VMEM wall, so one kernel serves every job count (W = 1,
// W = 2 and up to W = 16, i.e. 512 jobs, as template instances).
// Inputs may be a column prefix of a wider frame: both row strides are
// arguments.

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kSmemBytes = 48 * 1024;

template <int WT>
__global__ void lb2_sweep_kernel(const int* __restrict__ cf, long long ldc,
                                 const unsigned* __restrict__ sched,
                                 long long lds, int n, int J, int P, int W,
                                 int PB, const int4* __restrict__ steps,
                                 const int4* __restrict__ pairs,
                                 int* __restrict__ out) {
  extern __shared__ int4 sstep[];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < n;
  unsigned words[WT];
#pragma unroll
  for (int w = 0; w < WT; ++w)
    words[w] = (live && w < W) ? sched[(long long)w * lds + c] : 0u;

  int lb = INT_MIN;
  for (int p0 = 0; p0 < P; p0 += PB) {
    const int np = min(PB, P - p0);
    __syncthreads();
    for (int t = threadIdx.x; t < np * J; t += blockDim.x)
      sstep[t] = steps[(long long)p0 * J + t];
    __syncthreads();
    if (!live) continue;
    for (int q = 0; q < np; ++q) {
      const int4 pr = pairs[p0 + q];   // {ma0, ma1, tail[ma0], tail[ma1]}
      int t0 = cf[(long long)pr.x * ldc + c];
      int t1 = cf[(long long)pr.y * ldc + c];
      const int4* s = sstep + q * J;
      for (int j = 0; j < J; ++j) {
        const int4 st = s[j];          // {job, pt0, pt1, lag}
        const unsigned word = WT == 1 ? words[0] : words[st.x >> 5];
        const bool act = ((word >> (st.x & 31)) & 1u) == 0u;
        const int n0 = t0 + st.y;
        const int n1 = max(t1, n0 + st.w) + st.z;
        t0 = act ? n0 : t0;
        t1 = act ? n1 : t1;
      }
      lb = max(lb, max(t1 + pr.w, t0 + pr.z));
    }
  }
  if (live) out[c] = lb;
}

template <int WT>
cudaError_t launch(const int* cf, long long ldc, const unsigned* sched,
                   long long lds, int n, int J, int P, int W,
                   const int4* steps, const int4* pairs, int* out,
                   cudaStream_t stream) {
  int PB = kSmemBytes / (int)(sizeof(int4) * J);
  PB = std::max(1, std::min(PB, P));
  const size_t smem = sizeof(int4) * (size_t)PB * J;
  if (smem > (size_t)kSmemBytes) return cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  lb2_sweep_kernel<WT><<<blocks, kThreads, smem, stream>>>(
      cf, ldc, sched, lds, n, J, P, W, PB, steps, pairs, out);
  return cudaGetLastError();
}

}  // namespace

// cf: (M, >= n) int32 rows of stride ldc; sched: (W, >= n) uint32 rows of
// stride lds, W = ceil(J/32) <= 16; steps: (P, J) int4 {job, pt0, pt1,
// lag}; pairs: (P,) int4 {ma0, ma1, tail[ma0], tail[ma1]}; out: (n,) int32.
// Returns cudaGetLastError().
extern "C" int tts_lb2_sweep(const void* cf, long long ldc, const void* sched,
                             long long lds, int n, int J, int P,
                             const void* steps, const void* pairs, void* out,
                             void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int W = (J + 31) / 32;
  if (J < 1 || P < 1 || W > 16) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto args = [&](auto fn) {
    return fn((const int*)cf, ldc, (const unsigned*)sched, lds, n, J, P, W,
              (const int4*)steps, (const int4*)pairs, (int*)out, s);
  };
  if (W == 1) return (int)args(launch<1>);
  if (W == 2) return (int)args(launch<2>);
  return (int)args(launch<16>);
}
