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
// of pruned children stay exact, and telemetry bins them.
//
// What bounds it on this card: instruction issue. A column reads M*4 +
// W*4 bytes and writes 4, but runs P*J chain steps (166 pairs x 20 jobs
// in ta021's tail sweep, 1.09 G column-steps over its 327,680 columns).
// The first design (one thread per column, int32 chain, the active test
// as two selects) issued about nine instructions per column-step and took
// 0.6188 ms at ta021's tail shape, 0.7060 ms at ta071's (NVIDIA H100 80GB
// HBM3, 700 W, chip_smoke.py). Its time, and every variant's since, fits
// two issue cycles per warp-instruction of the chain. This design takes
// 0.3535 ms and 0.3253 ms there (device time, same card, chip_smoke.py),
// against bounds of 0.081 and 0.056 ms: the function's float32 adds and
// maxes of the unscheduled steps only, at 128 per clock per SM. A
// predicated-off step still issues.
//
// Design:
//  - One step is five instructions per column (chain_step): one LOP3
//    that tests the job's bit into a predicate, then add, add, max, add,
//    three of them predicated on it. No select, no branch, so a warp
//    never diverges, and t0 + lag is taken as old t0 + (pt0 + lag), off
//    the predicate's path.
//  - The chain runs in float32. It is exact: `make_tables` keeps every
//    value of the chain below 2^24 (its ceiling check, the same one the
//    TPU kernel's f32 arithmetic relies on), so every sum and max is an
//    integer that float32 holds exactly, and the result converts back
//    unchanged. Measured beside the same chain in int32 on the card,
//    float32 was the faster of the two at every J tried (20 to 500).
//  - Each thread of a wide sweep takes C columns at once (wide_cols(): 4
//    for W = 1, 8 for W > 1; a narrow sweep, one): one broadcast 16-byte
//    shared load of the step {bit mask, pt0, pt0 + lag, pt1} feeds all of
//    them, and their independent chains give the scheduler parallel work.
//  - Persistent blocks: the grid is the SM count times the blocks an SM
//    holds (read with cudaDeviceGetAttribute and the occupancy API), and
//    thread g takes columns g + (r*C + k)*T (T threads in all), so each
//    block stages the pair tables into shared memory once, not once per
//    128 columns, and a warp's loads stay coalesced. Tables above
//    kTableBytes (J = 500 x 190 pairs is 1.9 MB) stream through shared
//    memory a block of pairs at a time.
//  - The scheduled-set words stay out of local memory: W = 1 and a wide
//    W = 2 sweep keep them in registers (W = 2 picks its word with one
//    select); W > 2 (J > 64) and a narrow W = 2 sweep keep each thread's
//    words in its own slice of shared memory, addressed by a word offset
//    staged with the step.
// Inputs may be a column prefix of a wider frame: both row strides are
// arguments.
//
// Live columns: an optional device pointer holds the count of leading
// columns that are live (the survivors of a frame compacted on the
// device, whose count the host never reads). Only those are swept; the
// columns from the count to n are written I32_MAX. Each round spreads
// the columns it has left over as few threads as hold them, a multiple
// of 32, so a count far below n leaves most threads idle instead of
// sweeping dead columns, and a warp's loads stay coalesced.

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTableBytes = 96 * 1024;    // staged step tables per block

// one chain step, staged in shared memory: the job's bit in its
// scheduled-set word and the pair's three times for the job, as float32
struct Step {
  unsigned mask;
  float pt0, pl, pt1;   // pl = pt0 + lag
};

// t0 += pt0; t1 = max(t1, t0 + lag) + pt1, where the job's bit in `word`
// is clear. Written in PTX so that the update is predicated, not selected.
__device__ __forceinline__ void chain_step(float& t0, float& t1,
                                           unsigned word, const Step& s) {
  asm("{\n\t"
      ".reg .pred p;\n\t"
      ".reg .b32 m;\n\t"
      ".reg .f32 x;\n\t"
      "and.b32 m, %2, %3;\n\t"
      "setp.eq.u32 p, m, 0;\n\t"
      "add.f32 x, %0, %5;\n\t"
      "@p add.f32 %0, %0, %4;\n\t"
      "@p max.f32 %1, %1, x;\n\t"
      "@p add.f32 %1, %1, %6;\n\t"
      "}"
      : "+f"(t0), "+f"(t1)
      : "r"(word), "r"(s.mask), "f"(s.pt0), "f"(s.pl), "f"(s.pt1));
}

// Columns per thread on a wide sweep: one 16-byte step load (and, for
// W > 1, one load of the step's word index) feeds them all. Eight were
// faster than four for W > 1 on the card at J = 50..500; for W = 1 eight
// spill. A narrow sweep takes one column per thread instead, so that it
// still spreads over the card (`launch`).
template <int WT>
__host__ __device__ constexpr int wide_cols() {
  return WT == 1 ? 4 : 8;
}

// Shared memory of a block: pairs (P) | steps (PB*J) | word offsets
// (PB*J, W > 1) | scheduled-set words (W*C*kThreads, W > 2).
template <int WT>
__host__ __device__ constexpr size_t step_bytes() {
  return sizeof(Step) + (WT == 1 ? 0 : sizeof(int));
}

// WT = 1 or 2: that many scheduled-set words per column in registers;
// WT = 0: W >= 2 words per column in shared memory. C columns per thread.
template <int WT, int C>
__global__ void __launch_bounds__(kThreads)
lb2_sweep_kernel(const int* __restrict__ cf, long long ldc,
                 const unsigned* __restrict__ sched, long long lds, int n,
                 const int* __restrict__ live_ptr, int J, int P, int W,
                 int PB, const int4* __restrict__ steps,
                 const int4* __restrict__ pairs, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* spr = (int4*)smem;                 // {ma0, ma1, tail0, tail1 (f32)}
  Step* sst = (Step*)(spr + P);
  int* sof = (int*)(sst + PB * J);         // word index or offset per step
  unsigned* swd = (unsigned*)(sof + (WT == 1 ? 0 : PB * J));
  const int tid = threadIdx.x;
  const long long T = (long long)gridDim.x * kThreads;
  const long long g = (long long)blockIdx.x * kThreads + tid;
  const long long live =
      live_ptr ? max(0LL, min((long long)*live_ptr, (long long)n)) : n;

  for (int q = tid; q < P; q += kThreads) {
    const int4 pr = pairs[q];
    spr[q] = make_int4(pr.x, pr.y, __float_as_int((float)pr.z),
                       __float_as_int((float)pr.w));
  }
  auto stage = [&](int p0, int np) {
    for (int t = tid; t < np * J; t += kThreads) {
      const int4 st = steps[(long long)p0 * J + t];   // {job, pt0, pt1, lag}
      sst[t] = Step{1u << (st.x & 31), (float)st.y, (float)(st.y + st.w),
                    (float)st.z};
      if (WT == 2) sof[t] = st.x >> 5;
      if (WT == 0) sof[t] = (st.x >> 5) * C * kThreads;
    }
  };
  const bool once = PB == P;
  if (once) stage(0, P);
  __syncthreads();

  // rounds of C*T columns; the last one, holding `left` columns, runs
  // on its first S threads. live is the same for every thread of the
  // block, so every thread takes the same rounds (the staging below
  // synchronises the block).
  for (long long base = 0; base < live; base += C * T) {
    const long long left = live - base;
    const long long S =
        left >= C * T ? T : min(T, ((left + C - 1) / C + 31) / 32 * 32);
    const bool act = g < S;
    // a column past live sweeps column live - 1 again and is not
    // stored, so the chain carries no live-column test
    const long long c0 = base + g;
    long long c[C];
    unsigned w0[C], w1[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      c[k] = min(c0 + k * S, live - 1);
      w0[k] = WT != 0 ? sched[c[k]] : 0u;
      w1[k] = WT == 2 ? sched[lds + c[k]] : 0u;
      if (WT == 0)
        for (int v = 0; v < W; ++v)
          swd[(v * C + k) * kThreads + tid] = sched[(long long)v * lds + c[k]];
    }
    float lb[C];
#pragma unroll
    for (int k = 0; k < C; ++k) lb[k] = -__int_as_float(0x7f800000);

    for (int p0 = 0; p0 < P; p0 += PB) {
      const int np = min(PB, P - p0);
      if (!once) {
        __syncthreads();
        stage(p0, np);
        __syncthreads();
      }
      if (!act) continue;
      for (int q = 0; q < np; ++q) {
        const int4 pr = spr[p0 + q];
        float t0[C], t1[C];
#pragma unroll
        for (int k = 0; k < C; ++k) {
          t0[k] = (float)cf[(long long)pr.x * ldc + c[k]];
          t1[k] = (float)cf[(long long)pr.y * ldc + c[k]];
        }
        const Step* s = sst + q * J;
        const int* so = sof + q * J;
        for (int j = 0; j < J; ++j) {
          const Step st = s[j];
          if (WT == 0) {
            const unsigned* wp = swd + so[j] + tid;
#pragma unroll
            for (int k = 0; k < C; ++k)
              chain_step(t0[k], t1[k], wp[k * kThreads], st);
          } else {
            const bool hi = WT == 2 && so[j];
#pragma unroll
            for (int k = 0; k < C; ++k)
              chain_step(t0[k], t1[k], hi ? w1[k] : w0[k], st);
          }
        }
#pragma unroll
        for (int k = 0; k < C; ++k)
          lb[k] = fmaxf(lb[k], fmaxf(t1[k] + __int_as_float(pr.w),
                                     t0[k] + __int_as_float(pr.z)));
      }
    }
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (act && c0 + k * S < live) out[c[k]] = (int)lb[k];
  }
  for (long long c = live + g; c < n; c += T) out[c] = INT_MAX;
}

template <int WT, int C>
cudaError_t launch_cols(const int* cf, long long ldc, const unsigned* sched,
                        long long lds, int n, const int* live, int J, int P,
                        int W, int sms, const int4* steps,
                        const int4* pairs, int* out, cudaStream_t stream) {
  const int PB = std::max(
      1, std::min(P, (int)(kTableBytes / (step_bytes<WT>() * J))));
  const size_t smem = sizeof(int4) * P + step_bytes<WT>() * PB * J +
                      (WT == 0 ? sizeof(unsigned) * W * C * kThreads : 0);
  auto kernel = lb2_sweep_kernel<WT, C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long per_block = (long long)kThreads * C;
  const long long blocks = std::min<long long>(
      (long long)per_sm * sms, (n + per_block - 1) / per_block);
  kernel<<<(int)blocks, kThreads, smem, stream>>>(
      cf, ldc, sched, lds, n, live, J, P, W, PB, steps, pairs, out);
  return cudaGetLastError();
}

template <int WT>
cudaError_t launch(const int* cf, long long ldc, const unsigned* sched,
                   long long lds, int n, const int* live, int J, int P,
                   int W, const int4* steps, const int4* pairs, int* out,
                   cudaStream_t stream) {
  constexpr int C = wide_cols<WT>();
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // C columns a thread once the wide grid would cover every SM (half of
  // them for W > 1, whose eight columns per thread outran one column on
  // all SMs in the card's measurements), else one
  const long long wide_blocks = (n + kThreads * C - 1) / (kThreads * C);
  // (a narrow W = 2 sweep keeps its words in shared memory, as W > 2 does:
  // with them in registers ptxas spilled that instance)
  auto run = wide_blocks * (WT == 1 ? 1 : 2) >= sms
                 ? launch_cols<WT, C>
                 : launch_cols<WT == 1 ? 1 : 0, 1>;
  return run(cf, ldc, sched, lds, n, live, J, P, W, sms, steps, pairs, out,
             stream);
}

}  // namespace

// cf: (M, >= n) int32 rows of stride ldc; sched: (W, >= n) uint32 rows of
// stride lds, W = ceil(J/32) <= 16; live: null, or one int32 on the
// device, the count of live leading columns (clamped to [0, n]; columns
// past it are written I32_MAX); steps: (P, J) int4 {job, pt0, pt1, lag};
// pairs: (P,) int4 {ma0, ma1, tail[ma0], tail[ma1]}; out: (n,) int32.
// Every chain value must lie below 2^24 (make_tables checks it). Returns
// the first CUDA error of the launch, or 0.
extern "C" int tts_lb2_sweep(const void* cf, long long ldc, const void* sched,
                             long long lds, int n, const void* live, int J,
                             int P, const void* steps, const void* pairs,
                             void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int W = (J + 31) / 32;
  if (J < 1 || P < 1 || W > 16) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto args = [&](auto fn) {
    return fn((const int*)cf, ldc, (const unsigned*)sched, lds, n,
              (const int*)live, J, P, W, (const int4*)steps,
              (const int4*)pairs, (int*)out, s);
  };
  if (W == 1) return (int)args(launch<1>);
  if (W == 2) return (int)args(launch<2>);
  return (int)args(launch<0>);
}
