// Expand/bound of a popped chunk of PFSP parents, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_expand_kernel` and `_bounds_kernel` of
// tpu_tree_search/ops/pallas_expand.py (math in `_expand_math`): for every
// child slot i of every parent b, the child front (one add_forward chain
// over the machines) and its LB1 (machine_bound_from_parts on the child,
// c_bound_simple.c:126-141) or LB1_d (add_front_and_bound from the parent,
// c_bound_simple.c:218-244) bound. Bounds-only mode writes the bounds
// (INT_MAX at the slots below the parent's depth, which are no children);
// emit mode writes any non-empty set of: the child permutation (prefix
// swap depth <-> i, PFSP_lib.c:13-16), the child front (M rows), the
// depth+1 row, the bound, and the child's scheduled-set words (the
// parent's prefix words with the appended job's bit: sched_mask_cols).
// The dense LB2 route asks for the fronts and the words only. Outputs use
// the TPU kernel's column order c = (g*J + i)*TB + b, which is part of the
// engine's per-step parity contract.
//
// What bounds it on this card (an H100 SXM: 3.35 TB/s, 16.7 T int32
// operations/s). Bounds-only: int32 operations. A parent reads J*2 + 4 +
// M*4 bytes and writes J*4, while each real child costs 5-7 int32
// operations per machine (the front chain and the bound's max-plus chain):
// at 20x20 about 140 operations against 10 bytes moved per child, above
// the card's ratio (about 5 operations per byte). Emit: bytes, as the
// J*2 + (M+1)*4 + 4 bytes written per child dominate; the dense route's
// fronts and words are M*4 + SW*4.
//
// The first design gave one thread per parent and walked its J slots:
// 65,536 threads at ta021's chunk (a quarter of what the card holds) and
// 32 blocks for 132 SMs at a chunk of 4096, each thread a long serial
// chain, and emit wrote one int16 a lane (0.042 ms bounds-only at ta021,
// 0.153 at ta091's chunk, 0.042 emit at ta014's, 0.47 emit at ta041's;
// device time on NVIDIA H100 80GB HBM3 at 700 W, kernel_times.py). This
// design, two launches from one C call:
//  1. prep (lb1_chain.cuh's prep_parents, shared with fused_expand.cu):
//     every parent's remain (M int32; for the bounds) and its prefix words
//     (SW; for the words) into scratch, once per parent, split over up to
//     8 threads when the chunk is small or long. It lets the main pass
//     launch at once (programmatic dependent launch, a Hopper feature).
//  2. main: a block holds BT consecutive parents (lanes along b, so the
//     loads of front and remain and the stores at c coalesce) at K
//     consecutive slots, K (at most 8) from the shape so that the grid
//     holds at least kBlockFloor blocks (640 at a chunk of 4096 and
//     J = 20). Its blocks first load what the pre-pass does not write (p
//     and the tails into shared memory, the fronts, emit's permutations)
//     and emit writes what needs no remain (the fronts and the depth row,
//     the chain run without remain, and the children); then every block
//     waits for the pre-pass (griddepcontrol.wait) and runs the shared
//     chain (tts::child_bound) for the bounds, and writes the words.
//     Bounds-only, a slot below the depth gets INT_MAX with no math. p
//     sits in shared memory (M, J), as the chain reads it: at J > 32 lanes
//     that hold jobs 32 apart share a bank, and as a warp's jobs are random
//     any row stride prime to 32 conflicts as often; read through L1
//     instead, the gathers touched many more lines and ran slower.
//  3. emit's children: the block's permutations, (J, BT) int16, are staged
//     in shared memory with 16-byte loads; each thread then builds 8
//     adjacent parents' entries of one row of one slot's copy (rows d and
//     i swapped) and writes them with one 16-byte store, when TB is a
//     multiple of 8 (every tile the engine picks); else one int16 at a
//     time.
// There are no atomics: the outputs are deterministic. Times of this
// design are in PERF.md (kernel_times.py).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "lb1_chain.cuh"

namespace {

constexpr int kThreads = 128;     // parents a main block holds
constexpr int kSlots = 8;         // child slots a thread aims to hold
constexpr int kBlockFloor = 528;  // main blocks the grid aims for (4 an SM)
constexpr int kVec = 8;           // int16 children a 16-byte store holds

// The main kernel's grid: BT parents a block (64 when a block stages the
// permutations of more than 128 jobs), K slots a block, NG slot groups.
struct Geometry {
  int BT, K, NG;
  long long PB;  // parent blocks
};

Geometry geometry(int J, int B, bool stage_perms) {
  Geometry q;
  q.BT = stage_perms && J > 128 ? 64 : kThreads;
  q.PB = (B + q.BT - 1) / q.BT;
  int k = kSlots < J ? kSlots : J;
  while (k > 1 && q.PB * ((J + k - 1) / k) < kBlockFloor) k /= 2;
  q.K = k;
  q.NG = (J + k - 1) / k;
  return q;
}

// int32 words before the staged permutations in a main block's shared
// memory: p (M, J) and the min tails (M), rounded up to 16 bytes.
__host__ __device__ inline int main_smem_words(int J, int M) {
  return (M * J + M + 3) / 4 * 4;
}

struct Args {
  const int* p;
  const int* tails;
  const int16_t* prmu;
  const int* depth;
  const int* front;
  int J, M, B, TB, lb_kind, emit, SW;
  int16_t* children;
  int* fronts;     // (M, N) rows, or null
  int* depth_out;  // one row of N, or null
  int* bounds;
  int* sched;      // (SW, N), or null
  int* rem;        // scratch: (M, B)
  unsigned* pre;   // scratch: (SW, B)
};

// The pre-pass. It lets the main pass launch at once (programmatic
// dependent launch): the main pass's blocks do what does not depend on the
// pre-pass while its last blocks run, then wait for all of it.
template <int MAXM, int MC>
__global__ void expand_prep(Args a) {
  extern __shared__ int smem[];
  asm volatile("griddepcontrol.launch_dependents;");
  tts::prep_parents<MAXM>(smem, a.p, a.prmu, a.depth, a.J, MC ? MC : a.M,
                          a.B, a.SW, !a.emit || a.bounds, a.rem, a.pre);
}

union Vec8 {
  uint4 u;
  int16_t h[kVec];
};

// Emit's children from the staged permutations: one item is one row
// `pos` of slot i's copy (rows d and i swapped) for 8 adjacent parents,
// written with one 16-byte store when TB is a multiple of 8 (every tile the
// engine picks), else one int16 at a time; neighbouring threads take
// neighbouring parents, then rows, then slots.
__device__ __forceinline__ void write_children(
    const Args& a, const int16_t* sperm, const int16_t* sdep,
    const int16_t* sjd, int b0, int i0, int kk, int BT, long long N) {
  const int J = a.J, B = a.B, TB = a.TB;
  const int nchunk = BT / kVec;
  const int items = kk * J * nchunk;
  const bool vec = TB % kVec == 0;
  for (int it = threadIdx.x; it < items; it += BT) {
    const int c = it % nchunk;
    const int rest = it / nchunk;
    const int pos = rest % J;
    const int i = i0 + rest / J;
    const int t0 = c * kVec;
    if (b0 + t0 >= B) continue;
    Vec8 v, jv, dd, jd;
    v.u = *(const uint4*)(sperm + pos * BT + t0);
    jv.u = *(const uint4*)(sperm + i * BT + t0);
    dd.u = *(const uint4*)(sdep + t0);
    jd.u = *(const uint4*)(sjd + t0);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      v.h[e] = pos == dd.h[e] ? jv.h[e] : pos == i ? jd.h[e] : v.h[e];
    int16_t* row = a.children + (long long)pos * N;
    if (vec) {
      // 8 parents of one tile (TB and b0 + t0 are multiples of 8)
      const int bc = b0 + t0;
      const int gc = bc / TB;
      *(uint4*)(row + (long long)(gc * J + i) * TB + (bc - gc * TB)) = v.u;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int bc = b0 + t0 + e;
        if (bc >= B) break;
        const int gc = bc / TB;
        row[(long long)(gc * J + i) * TB + (bc - gc * TB)] = v.h[e];
      }
    }
  }
}

template <int MAXM, int MC, bool EMIT>
__global__ void __launch_bounds__(kThreads) expand_main(Args a, int K) {
  extern __shared__ int smem[];
  const int J = a.J, B = a.B, TB = a.TB;
  const int Mx = MC ? MC : a.M;
  int* sp = smem;            // p, (M, J)
  int* st = smem + Mx * J;   // min tails, (M,)
  // the children: the block's permutations, (J, BT), then the depth
  // (clamped into [-1, J], which keeps `pos == d` exact) and the job at
  // the depth of each parent, BT each
  int16_t* sperm = (int16_t*)(smem + main_smem_words(J, Mx));
  const int tid = threadIdx.x;
  const int BT = blockDim.x;
  int16_t* sdep = sperm + J * BT;
  int16_t* sjd = sdep + BT;
  const bool stage = EMIT && a.children != nullptr;

  const int b0 = blockIdx.x * BT;
  const int i0 = blockIdx.y * K;
  const int kk = min(K, J - i0);
  const int b = b0 + tid;
  const bool live = b < B;
  const long long N = (long long)B * J;
  const int g = b / TB;
  // column of slot i: base + i * TB
  const long long base = (long long)g * J * TB + (b - g * TB);
  const int d = live ? a.depth[b] : 0;
  // bounds-only, a parent whose slots here all lie below its depth has no
  // child to bound; emit needs remain only for the bounds
  const bool need = live && (EMIT || d < i0 + kk);
  const bool need_rem = need && (!EMIT || a.bounds);

  // first every load that does not need the pre-pass
  for (int t = tid; t < Mx * J; t += BT) sp[t] = a.p[t];
  for (int t = tid; t < Mx; t += BT) st[t] = a.tails[t];
  if (stage) {
    // 8 parents a load when whole aligned 16-byte pieces of each row are
    // the block's (B a multiple of 8), every load in flight at once
    if (B % kVec == 0 && ((size_t)a.prmu & 15) == 0) {
      const int nchunk = BT / kVec;
#pragma unroll 4
      for (int t = tid; t < J * nchunk; t += BT) {
        const int pos = t / nchunk, c = t - pos * nchunk;
        const int bc = b0 + c * kVec;
        *(uint4*)(sperm + pos * BT + c * kVec) =
            bc < B ? *(const uint4*)(a.prmu + (long long)pos * B + bc)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int pos = 0; pos < J; ++pos)
        sperm[pos * BT + tid] = live ? a.prmu[(long long)pos * B + b] : 0;
    }
    sdep[tid] = (int16_t)min(max(d, -1), J);
    sjd[tid] = live ? a.prmu[(long long)min(max(d, 0), J - 1) * B + b] : 0;
  }
  int fr[MAXM], rem[MAXM];
#pragma unroll
  for (int k = 0; k < MAXM; ++k)
    fr[k] = (need && k < Mx) ? a.front[(long long)k * B + b] : 0;

  if (EMIT) {
    // then what needs no pre-pass, written while its last blocks run: the
    // fronts and the depth row (the chain without remain; its bound is
    // dropped), and the children
    __syncthreads();
    if (live && (a.fronts || a.depth_out)) {
      int none[MAXM] = {};
      for (int kq = 0; kq < kk; ++kq) {
        const int i = i0 + kq;
        const long long col = base + (long long)i * TB;
        const int jv = a.prmu[(long long)i * B + b];
        tts::child_bound<MAXM>(
            sp, st, fr, none, Mx, J, tts::job_index(jv, J), 1,
            [&](int k, int cf) {
              if (a.fronts) a.fronts[(long long)k * N + col] = cf;
            });
        if (a.depth_out) a.depth_out[col] = d + 1;
      }
    }
    if (stage) write_children(a, sperm, sdep, sjd, b0, i0, kk, BT, N);
  }

  // every block waits, so the main pass ends after the pre-pass
  asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
  for (int k = 0; k < MAXM; ++k)
    rem[k] = (need_rem && k < Mx) ? a.rem[(long long)k * B + b] : 0;
  if (!EMIT) __syncthreads();
  if (!live || (EMIT && !a.bounds && !a.sched)) return;
  for (int kq = 0; kq < kk; ++kq) {
    const int i = i0 + kq;
    const long long col = base + (long long)i * TB;
    if (!EMIT && i < d) {
      a.bounds[col] = INT_MAX;
      continue;
    }
    const int jv = a.prmu[(long long)i * B + b];
    if (!EMIT || a.bounds)
      a.bounds[col] = tts::child_bound<MAXM>(
          sp, st, fr, rem, Mx, J, tts::job_index(jv, J), a.lb_kind,
          [](int, int) {});
    if (EMIT) {
      for (int w = 0; w < a.SW; ++w) {
        unsigned bits = a.pre[(long long)w * B + b];
        if (jv >= 32 * w && jv < 32 * (w + 1)) bits |= 1u << (jv - 32 * w);
        a.sched[(long long)w * N + col] = (int)bits;  // bit 31: the sign
      }
    }
  }
}

template <typename F>
cudaError_t allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int MAXM, int MC>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const bool stage = a.emit && a.children;
  const Geometry q = geometry(a.J, a.B, stage);
  const int S = tts::prep_splits(a.J, a.B), PX = tts::kPrepThreads / S;
  const size_t smem_prep =
      sizeof(int) * tts::prep_smem_words(a.J, a.M, a.SW, S);
  const size_t smem_main =
      sizeof(int) * (size_t)main_smem_words(a.J, a.M) +
      (stage ? sizeof(int16_t) * (size_t)(a.J + 2) * q.BT : 0);
  auto pass = a.emit ? expand_main<MAXM, MC, true>
                     : expand_main<MAXM, MC, false>;
  cudaError_t e = allow_smem(expand_prep<MAXM, MC>, smem_prep);
  if (e == cudaSuccess) e = allow_smem(pass, smem_main);
  if (e != cudaSuccess) return e;
  expand_prep<MAXM, MC><<<(a.B + PX - 1) / PX, dim3(PX, S), smem_prep, s>>>(
      a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)q.PB, q.NG);
  cfg.blockDim = dim3(q.BT);
  cfg.dynamicSmemBytes = smem_main;
  cfg.stream = s;
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = overlap;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, pass, a, q.K);
}

}  // namespace

// p (M, J) int32; tails (M,) int32; prmu (J, B) int16; depth (B,) int32;
// front (M, B) int32, all contiguous; N = B*J.
// emit == 0 (bounds-only): bounds (N,) int32; every other output null and
// SW = 0. emit != 0: any non-empty set of children (J, N) int16, fronts
// (M rows of N int32, N apart), depth_out (N,) int32 = depth+1, bounds
// (N,) int32 and sched (SW, N) int32 with SW = ceil(J / 32); the others
// null. scratch: at least (M + SW) * B int32 words (remain, then prefix
// words). B must be a multiple of TB, 1 <= M <= 32, B*J < 2^31, lb_kind 0
// or 1. Launches the pre-pass and the main pass on `stream`; returns the
// first CUDA error, or 0.
extern "C" int tts_expand_bound(const void* p, const void* tails,
                                const void* prmu, const void* depth,
                                const void* front, int J, int M, int B,
                                int TB, int lb_kind, int emit, int SW,
                                void* children, void* fronts,
                                void* depth_out, void* bounds, void* sched,
                                void* scratch, long long scratch_len,
                                void* stream) {
  if (B == 0) return (int)cudaSuccess;
  const bool any = children || fronts || depth_out || bounds || sched;
  if (M < 1 || M > 32 || J < 1 || B < 0 || TB <= 0 || B % TB != 0 ||
      (long long)B * J >= INT_MAX || (lb_kind != 0 && lb_kind != 1) ||
      SW != (sched ? (J + 31) / 32 : 0) ||
      scratch_len < (long long)(M + SW) * B || scratch == nullptr ||
      (emit ? !any
            : (!bounds || children || fronts || depth_out || sched)))
    return (int)cudaErrorInvalidValue;
  Args a{(const int*)p, (const int*)tails, (const int16_t*)prmu,
         (const int*)depth, (const int*)front, J, M, B, TB, lb_kind,
         emit != 0, SW, (int16_t*)children, (int*)fronts, (int*)depth_out,
         (int*)bounds, (int*)sched, (int*)scratch,
         (unsigned*)scratch + (long long)M * B};
  auto s = (cudaStream_t)stream;
  // the Taillard machine counts get instances with M fixed at compile
  // time, as in fused_expand.cu
  if (M == 5) return (int)launch<5, 5>(a, s);
  if (M == 10) return (int)launch<10, 10>(a, s);
  if (M == 20) return (int)launch<20, 20>(a, s);
  if (M <= 8) return (int)launch<8, 0>(a, s);
  if (M <= 16) return (int)launch<16, 0>(a, s);
  return (int)launch<32, 0>(a, s);
}
