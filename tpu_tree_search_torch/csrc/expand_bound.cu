// Expand/bound of a popped chunk of PFSP parents, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_expand_kernel` and `_bounds_kernel` of
// tpu_tree_search/ops/pallas_expand.py (math in `_expand_math`): for every
// child slot i of every parent b, the child front (one add_forward chain
// over the machines) and its LB1 (machine_bound_from_parts on the child,
// c_bound_simple.c:126-141) or LB1_d (add_front_and_bound from the parent,
// c_bound_simple.c:218-244) bound; with `emit` also the child permutation
// (prefix swap depth <-> i, PFSP_lib.c:13-16) and [child front | depth+1].
// Outputs use the TPU kernel's column order c = (g*J + i)*TB + b, which is
// part of the engine's per-step parity contract.
//
// What bounds it on this card. Bounds-only: int32 operations. A parent
// reads J*2 + 4 + M*4 bytes and writes J*4, while each real child costs
// 5-7 int32 operations per machine (the front chain and the bound's
// max-plus chain); at 20x20 that is ~140 operations against ~10 bytes
// moved per child, above the card's ratio of int32 rate to memory rate
// (~5 operations per byte), so chip_smoke.py's bound says operations at
// ta021. With `emit`:
// bytes, as the J*2 + (M+1)*4 bytes written per child dominate.
//
// Design: one thread per parent column. It loads its front into registers
// and computes `remain` (unscheduled work per machine) once; the
// processing-time table p (M x J int32, at most 40 KB at 500x20) and the
// tails sit in shared memory. It then walks its J child slots; neighbouring
// threads write neighbouring columns, so every store is coalesced. All
// arithmetic is exact int32 (the TPU kernel's f32 one-hot matmuls are exact
// below 2^24, so the values are equal). Bounds-only, the slots below the
// parent's depth are not children; the kernel writes INT_MAX there and
// skips their math. The parent state and the per-child chain live in
// lb1_chain.cuh, shared with fused_expand.cu.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "lb1_chain.cuh"

namespace {

template <int MAXM>
__global__ void expand_bound_kernel(
    const int* __restrict__ p, const int* __restrict__ tails,
    const int16_t* __restrict__ prmu, const int* __restrict__ depth,
    const int* __restrict__ front, int J, int M, int B, int TB, int lb_kind,
    int emit, int16_t* __restrict__ children, int* __restrict__ aux,
    int* __restrict__ bounds) {
  extern __shared__ int smem[];
  int* sp = smem;            // p, (M, J) row-major
  int* st = smem + M * J;    // min tails, (M,)
  for (int t = threadIdx.x; t < M * J; t += blockDim.x) sp[t] = p[t];
  for (int t = threadIdx.x; t < M; t += blockDim.x) st[t] = tails[t];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long N = (long long)B * J;
  const int g = b / TB;
  const int bb = b - g * TB;
  const int d = depth[b];

  int fr[MAXM], rem[MAXM];
  tts::parent_state<MAXM>(sp, prmu, front, J, M, B, b, d, fr, rem);
  const int jd = (d >= 0 && d < J) ? prmu[(long long)d * B + b] : prmu[b];

  int i0 = d;
  if (emit) {
    i0 = 0;
  } else {
    for (int i = 0; i < d && i < J; ++i)
      bounds[((long long)g * J + i) * TB + bb] = INT_MAX;
  }
  for (int i = max(i0, 0); i < J; ++i) {
    const long long col = ((long long)g * J + i) * TB + bb;
    const int jv = prmu[(long long)i * B + b];
    const int lb = tts::child_bound<MAXM>(
        sp, st, fr, rem, M, J, tts::job_index(jv, J), lb_kind,
        [&](int k, int cf) {
          if (emit) aux[(long long)k * N + col] = cf;
        });
    bounds[col] = lb;
    if (emit) {
      aux[(long long)M * N + col] = d + 1;
      for (int pos = 0; pos < J; ++pos) {
        const int16_t v = pos == d ? (int16_t)jv
                          : pos == i ? (int16_t)jd
                                     : prmu[(long long)pos * B + b];
        children[(long long)pos * N + col] = v;
      }
    }
  }
}

template <int MAXM>
cudaError_t launch(const int* p, const int* tails, const int16_t* prmu,
                   const int* depth, const int* front, int J, int M, int B,
                   int TB, int lb_kind, int emit, int16_t* children, int* aux,
                   int* bounds, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  const size_t smem = sizeof(int) * (size_t)(M * J + M);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        expand_bound_kernel<MAXM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  expand_bound_kernel<MAXM><<<blocks, threads, smem, stream>>>(
      p, tails, prmu, depth, front, J, M, B, TB, lb_kind, emit, children,
      aux, bounds);
  return cudaGetLastError();
}

}  // namespace

// p (M, J) int32; tails (M,) int32; prmu (J, B) int16; depth (B,) int32;
// front (M, B) int32, all contiguous. Outputs: bounds (N,) int32 and, when
// emit != 0, children (J, N) int16 and aux (M+1, N) int32; N = B*J.
// B must be a multiple of TB, 1 <= M <= 32. Returns cudaGetLastError().
extern "C" int tts_expand_bound(const void* p, const void* tails,
                                const void* prmu, const void* depth,
                                const void* front, int J, int M, int B,
                                int TB, int lb_kind, int emit, void* children,
                                void* aux, void* bounds, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (M < 1 || M > 32 || J < 1 || TB <= 0 || B % TB != 0)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto args = [&](auto fn) {
    return fn((const int*)p, (const int*)tails, (const int16_t*)prmu,
              (const int*)depth, (const int*)front, J, M, B, TB, lb_kind,
              emit, (int16_t*)children, (int*)aux, (int*)bounds, s);
  };
  if (M <= 8) return (int)args(launch<8>);
  if (M <= 16) return (int)args(launch<16>);
  return (int)args(launch<32>);
}
