// Native host runtime for tpu-tree-search.
//
// The reference engine's host side is C (pool management, sequential
// search, instance generation — pfsp/pfsp_c.c, pfsp/lib/*). The TPU
// framework keeps its hot path on-device (JAX/XLA), but still needs a fast
// host engine for: BFS warm-up seeding of device pools (step 1 of the
// reference's 3-phase schedule), golden-count oracles for tests, and a
// host-side drain analogous to the reference's step 3. This file is that
// runtime, written as idiomatic C++17 and exposed through a C ABI consumed
// via ctypes (tpu_tree_search/native/__init__.py).
//
// Algorithmic contracts mirrored exactly (validated against the Python
// oracle and the reference counts in tests):
//   - Taillard generator: Lehmer LCG with float32 division
//     (reference: pfsp/lib/c_taillard.c:76-105)
//   - LB1 / LB1_d / LB2 bounds (c_bound_simple.c, c_bound_johnson.c)
//   - decompose counting semantics (PFSP_lib.c:7-129)
//   - N-Queens safety + branching (nqueens/nqueens_c.c:80-117)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr int kIntMax = std::numeric_limits<int>::max();

// ---------------------------------------------------------------------- //
// Taillard instances

const long kTimeSeeds[120] = {
    873654221,  379008056,  1866992158, 216771124,  495070989,
    402959317,  1369363414, 2021925980, 573109518,  88325120,
    587595453,  1401007982, 873136276,  268827376,  1634173168,
    691823909,  73807235,   1273398721, 2065119309, 1672900551,
    479340445,  268827376,  1958948863, 918272953,  555010963,
    2010851491, 1519833303, 1748670931, 1923497586, 1829909967,
    1328042058, 200382020,  496319842,  1203030903, 1730708564,
    450926852,  1303135678, 1273398721, 587288402,  248421594,
    1958948863, 575633267,  655816003,  1977864101, 93805469,
    1803345551, 49612559,   1899802599, 2013025619, 578962478,
    1539989115, 691823909,  655816003,  1315102446, 1949668355,
    1923497586, 1805594913, 1861070898, 715643788,  464843328,
    896678084,  1179439976, 1122278347, 416756875,  267829958,
    1835213917, 1328833962, 1418570761, 161033112,  304212574,
    1539989115, 655816003,  960914243,  1915696806, 2013025619,
    1168140026, 1923497586, 167698528,  1528387973, 993794175,
    450926852,  1462772409, 1021685265, 83696007,   508154254,
    1861070898, 26482542,   444956424,  2115448041, 118254244,
    471503978,  1215892992, 135346136,  1602504050, 160037322,
    551454346,  519485142,  383947510,  1968171878, 540872513,
    2013025619, 475051709,  914834335,  810642687,  1019331795,
    2056065863, 1342855162, 1325809384, 1988803007, 765656702,
    1368624604, 450181436,  1927888393, 1759567256, 606425239,
    19268348,   1298201670, 2041736264, 379756761,  28837162};

const int kOptimal[120] = {
    1278, 1359, 1081, 1293, 1235, 1195, 1234, 1206, 1230, 1108,
    1582, 1659, 1496, 1377, 1419, 1397, 1484, 1538, 1593, 1591,
    2297, 2099, 2326, 2223, 2291, 2226, 2273, 2200, 2237, 2178,
    2724, 2834, 2621, 2751, 2863, 2829, 2725, 2683, 2552, 2782,
    2991, 2867, 2839, 3063, 2976, 3006, 3093, 3037, 2897, 3065,
    3846, 3699, 3640, 3719, 3610, 3679, 3704, 3691, 3741, 3755,
    5493, 5268, 5175, 5014, 5250, 5135, 5246, 5094, 5448, 5322,
    5770, 5349, 5676, 5781, 5467, 5303, 5595, 5617, 5871, 5845,
    6173, 6183, 6252, 6254, 6285, 6331, 6223, 6372, 6247, 6404,
    10862, 10480, 10922, 10889, 10524, 10329, 10854, 10730, 10438, 10675,
    11158, 11160, 11281, 11275, 11259, 11176, 11337, 11301, 11146, 11284,
    26040, 26500, 26371, 26456, 26334, 26469, 26389, 26560, 26005, 26457};

int jobsOf(int inst) {
  if (inst > 110) return 500;
  if (inst > 90) return 200;
  if (inst > 60) return 100;
  if (inst > 30) return 50;
  return 20;
}

int machinesOf(int inst) {
  if (inst > 100) return 20;
  if (inst > 90) return 10;
  if (inst > 80) return 20;
  if (inst > 70) return 10;
  if (inst > 60) return 5;
  if (inst > 50) return 20;
  if (inst > 40) return 10;
  if (inst > 30) return 5;
  if (inst > 20) return 20;
  if (inst > 10) return 10;
  return 5;
}

// One Lehmer LCG draw in [lo, hi]; float-division rounding per the
// published generator (c_taillard.c:76-88).
long lehmerDraw(long& seed, long lo, long hi) {
  constexpr long m = 2147483647, a = 16807, b = 127773, c = 2836;
  long k = seed / b;
  seed = a * (seed % b) - k * c;
  if (seed < 0) seed += m;
  double u = static_cast<float>(seed) / static_cast<float>(m);
  return lo + static_cast<long>(u * (hi - lo + 1));
}

void generateMatrix(int inst, int* out) {
  int n = jobsOf(inst), mm = machinesOf(inst);
  long seed = kTimeSeeds[inst - 1];
  for (int i = 0; i < mm * n; ++i) out[i] = static_cast<int>(lehmerDraw(seed, 1, 99));
}

// ---------------------------------------------------------------------- //
// Bounds

struct Bounds {
  int jobs, machines, pairs;
  std::vector<int> p;          // machines x jobs
  std::vector<int> minHeads, minTails;
  // LB2 all-pairs Johnson tables
  std::vector<int> pairM1, pairM2;    // (pairs)
  std::vector<int> lag;               // (pairs x jobs)
  std::vector<int> johnson;           // (pairs x jobs) job ids

  Bounds(const int* pt, int j, int m) : jobs(j), machines(m), p(pt, pt + m * j) {
    buildHeadsTails();
    buildJohnson();
  }

  int pt(int mach, int job) const { return p[mach * jobs + job]; }

  void buildHeadsTails() {
    minHeads.assign(machines, kIntMax);
    minTails.assign(machines, kIntMax);
    minHeads[0] = 0;
    minTails[machines - 1] = 0;
    for (int job = 0; job < jobs; ++job) {
      int acc = 0;
      for (int k = 0; k + 1 < machines; ++k) {
        acc += pt(k, job);
        minHeads[k + 1] = std::min(minHeads[k + 1], acc);
      }
      acc = 0;
      for (int k = machines - 1; k > 0; --k) {
        acc += pt(k, job);
        minTails[k - 1] = std::min(minTails[k - 1], acc);
      }
    }
  }

  void buildJohnson() {
    pairs = machines * (machines - 1) / 2;
    pairM1.reserve(pairs);
    pairM2.reserve(pairs);
    for (int a = 0; a + 1 < machines; ++a)
      for (int b = a + 1; b < machines; ++b) {
        pairM1.push_back(a);
        pairM2.push_back(b);
      }
    lag.assign(static_cast<size_t>(pairs) * jobs, 0);
    johnson.resize(static_cast<size_t>(pairs) * jobs);
    std::vector<int> order(jobs);
    for (int s = 0; s < pairs; ++s) {
      int m1 = pairM1[s], m2 = pairM2[s];
      for (int job = 0; job < jobs; ++job)
        for (int k = m1 + 1; k < m2; ++k) lag[s * jobs + job] += pt(k, job);
      // Johnson's rule for the 2-machine relaxation (ties by job id; any
      // tie-consistent order is optimal so bound values are unaffected)
      for (int job = 0; job < jobs; ++job) order[job] = job;
      const int* lg = &lag[s * jobs];
      std::stable_sort(order.begin(), order.end(), [&](int x, int y) {
        int ax = pt(m1, x) + lg[x], bx = pt(m2, x) + lg[x];
        int ay = pt(m1, y) + lg[y], by = pt(m2, y) + lg[y];
        int px = ax >= bx, py = ay >= by;     // partition: 0 first
        if (px != py) return px < py;
        int kx = px ? -bx : ax;               // asc ptm1 / desc ptm2
        int ky = py ? -by : ay;
        return kx < ky;
      });
      std::copy(order.begin(), order.end(), johnson.begin() + s * jobs);
    }
  }

  // Append one job to a prefix completion vector (add_forward semantics).
  void appendJob(int job, int* front) const {
    front[0] += pt(0, job);
    for (int k = 1; k < machines; ++k)
      front[k] = std::max(front[k - 1], front[k]) + pt(k, job);
  }

  // LB1 of a child = parent front + job, chained with remain and tails
  // (machine_bound_from_parts semantics, c_bound_simple.c:126-158).
  int lb1Child(const int* parentFront, const int* parentRemain, int job) const {
    int f = parentFront[0] + pt(0, job);
    int r = parentRemain[0] - pt(0, job);
    int chain = f + r;
    int lb = chain + minTails[0];
    for (int k = 1; k < machines; ++k) {
      f = std::max(f, parentFront[k]) + pt(k, job);
      r = parentRemain[k] - pt(k, job);
      chain = std::max(chain, f + r);
      lb = std::max(lb, chain + minTails[k]);
    }
    return lb;
  }

  // LB1_d of a child (add_front_and_bound semantics, c_bound_simple.c:218-244).
  int lb1dChild(const int* front, const int* remain, int job) const {
    int lb = front[0] + remain[0] + minTails[0];
    int t = front[0] + pt(0, job);
    for (int k = 1; k < machines; ++k) {
      int u = std::max(t, front[k]);
      lb = std::max(lb, u + remain[k] + minTails[k]);
      t = u + pt(k, job);
    }
    return lb;
  }

  // LB2 of a child whose prefix completion vector is `front` and whose
  // unscheduled set is `unsched` (list of job ids). Early exit once the
  // bound exceeds `cutoff` (c_bound_johnson.c:211-237 semantics).
  int lb2Child(const int* front, const std::vector<char>& isUnsched,
               int cutoff) const {
    int lb = 0;
    for (int s = 0; s < pairs; ++s) {
      int m1 = pairM1[s], m2 = pairM2[s];
      int t0 = front[m1], t1 = front[m2];
      const int* js = &johnson[s * jobs];
      const int* lg = &lag[s * jobs];
      for (int idx = 0; idx < jobs; ++idx) {
        int job = js[idx];
        if (!isUnsched[job]) continue;
        t0 += pt(m1, job);
        t1 = std::max(t1, t0 + lg[job]) + pt(m2, job);
      }
      int val = std::max(t1 + minTails[m2], t0 + minTails[m1]);
      lb = std::max(lb, val);
      if (lb > cutoff) break;
    }
    return lb;
  }
};

// ---------------------------------------------------------------------- //
// Sequential engine (DFS stack or BFS queue over an SoA node store)

struct NodeStore {
  int jobs;
  std::vector<int16_t> prmu;   // n x jobs
  std::vector<int16_t> depth;  // n
  size_t count = 0;
  size_t head = 0;             // BFS read cursor

  explicit NodeStore(int j) : jobs(j) {}

  void push(const int16_t* perm, int16_t d) {
    prmu.insert(prmu.end(), perm, perm + jobs);
    depth.push_back(d);
    ++count;
  }
  bool empty() const { return head >= count; }
  size_t live() const { return count - head; }
  // DFS pop (from the back)
  void popBack(int16_t* perm, int16_t* d) {
    --count;
    std::memcpy(perm, &prmu[count * jobs], jobs * sizeof(int16_t));
    *d = depth[count];
    prmu.resize(count * jobs);
    depth.resize(count);
  }
  // BFS pop (from the front; storage reclaimed lazily)
  void popFront(int16_t* perm, int16_t* d) {
    std::memcpy(perm, &prmu[head * jobs], jobs * sizeof(int16_t));
    *d = depth[head];
    ++head;
  }
};

struct SearchCounters {
  unsigned long long tree = 0, sol = 0;
  int best = kIntMax;
};

// Evaluate + branch one node, with exact decompose counting semantics
// (PFSP_lib.c:7-129). Pushes surviving children into `out`.
void expandNode(const Bounds& b, int lbKind, const int16_t* perm, int d,
                SearchCounters& c, NodeStore& out) {
  const int jobs = b.jobs, machines = b.machines;
  // prefix completion + unscheduled work per machine
  std::vector<int> front(machines, 0), remain(machines, 0);
  for (int i = 0; i < d; ++i) b.appendJob(perm[i], front.data());
  for (int k = 0; k < machines; ++k) {
    int tot = 0;
    for (int i = d; i < jobs; ++i) tot += b.pt(k, perm[i]);
    remain[k] = tot;
  }

  std::vector<char> isUnsched;
  std::vector<int> childFront;
  if (lbKind == 2) {
    isUnsched.assign(jobs, 0);
    for (int i = d; i < jobs; ++i) isUnsched[perm[i]] = 1;
    childFront.resize(machines);
  }

  std::vector<int16_t> child(perm, perm + jobs);
  for (int i = d; i < jobs; ++i) {
    int job = perm[i];
    int bound;
    switch (lbKind) {
      case 0: bound = b.lb1dChild(front.data(), remain.data(), job); break;
      case 2: {
        std::copy(front.begin(), front.end(), childFront.begin());
        b.appendJob(job, childFront.data());
        isUnsched[job] = 0;
        bound = b.lb2Child(childFront.data(), isUnsched, c.best);
        isUnsched[job] = 1;
        break;
      }
      default: bound = b.lb1Child(front.data(), remain.data(), job); break;
    }
    if (d + 1 == jobs) {
      ++c.sol;
      if (bound < c.best) c.best = bound;
    } else if (bound < c.best) {
      std::copy(perm, perm + jobs, child.begin());
      std::swap(child[d], child[i]);
      out.push(child.data(), static_cast<int16_t>(d + 1));
      ++c.tree;
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------- //
// C ABI

extern "C" {

int tts_nb_jobs(int inst) { return jobsOf(inst); }
int tts_nb_machines(int inst) { return machinesOf(inst); }
int tts_optimal_makespan(int inst) { return kOptimal[inst - 1]; }
void tts_processing_times(int inst, int* out) { generateMatrix(inst, out); }

// Depth-first B&B to exhaustion (or maxNodes expansions). initUb <= 0
// means an infinite initial incumbent. Returns expanded-node count.
long long tts_search(const int* p, int jobs, int machines, int lbKind,
                     int initUb, long long maxNodes,
                     unsigned long long* tree, unsigned long long* sol,
                     int* best) {
  Bounds b(p, jobs, machines);
  SearchCounters c;
  if (initUb > 0) c.best = initUb;
  NodeStore pool(jobs);
  std::vector<int16_t> root(jobs);
  for (int i = 0; i < jobs; ++i) root[i] = static_cast<int16_t>(i);
  pool.push(root.data(), 0);

  std::vector<int16_t> perm(jobs);
  int16_t d;
  long long expanded = 0;
  while (pool.count > 0 && (maxNodes <= 0 || expanded < maxNodes)) {
    pool.popBack(perm.data(), &d);
    ++expanded;
    expandNode(b, lbKind, perm.data(), d, c, pool);
  }
  *tree = c.tree;
  *sol = c.sol;
  *best = c.best;
  return expanded;
}

// Breadth-first warm-up: expand until the frontier reaches `target` nodes
// (or the tree is exhausted), then copy the frontier out. Returns the
// frontier size (-1 if it exceeds `cap`).
long long tts_bfs_frontier(const int* p, int jobs, int machines, int lbKind,
                           int initUb, long long target, long long cap,
                           int16_t* outPrmu, int16_t* outDepth,
                           unsigned long long* tree, unsigned long long* sol,
                           int* best) {
  Bounds b(p, jobs, machines);
  SearchCounters c;
  if (initUb > 0) c.best = initUb;
  NodeStore pool(jobs);
  std::vector<int16_t> root(jobs);
  for (int i = 0; i < jobs; ++i) root[i] = static_cast<int16_t>(i);
  pool.push(root.data(), 0);

  std::vector<int16_t> perm(jobs);
  int16_t d;
  while (!pool.empty() && static_cast<long long>(pool.live()) < target) {
    pool.popFront(perm.data(), &d);
    expandNode(b, lbKind, perm.data(), d, c, pool);
  }
  long long n = static_cast<long long>(pool.live());
  if (n > cap) return -1;
  for (long long i = 0; i < n; ++i) {
    std::memcpy(outPrmu + i * jobs, &pool.prmu[(pool.head + i) * jobs],
                jobs * sizeof(int16_t));
    outDepth[i] = pool.depth[pool.head + i];
  }
  *tree = c.tree;
  *sol = c.sol;
  *best = c.best;
  return n;
}

// Depth-first B&B from a given seed set — the heterogeneous hand-off
// path: the device engine pops its residual pool to the host and native
// threads finish it (the analogue of the reference's CPU workers and
// final CPU drain, pfsp_multigpu_cuda.c:236-263 / 487-495). Threads own
// round-robin stripes of the seeds (roundRobin_distribution semantics)
// and share the incumbent through an atomic (checkBest,
// pfsp_multigpu_cuda.c:30-50). Returns expanded-node count.
long long tts_search_from(const int* p, int jobs, int machines, int lbKind,
                          int initUb, const int16_t* seedPrmu,
                          const int16_t* seedDepth, long long nSeeds,
                          int nThreads, unsigned long long* tree,
                          unsigned long long* sol, int* best) {
  Bounds b(p, jobs, machines);
  if (nThreads < 1) nThreads = 1;
  std::atomic<int> sharedBest(initUb > 0 ? initUb : kIntMax);
  std::vector<unsigned long long> trees(nThreads, 0), sols(nThreads, 0);
  std::vector<long long> expandedPer(nThreads, 0);

  auto worker = [&](int t) {
    SearchCounters c;
    c.best = sharedBest.load(std::memory_order_relaxed);
    NodeStore pool(jobs);
    for (long long i = t; i < nSeeds; i += nThreads)
      pool.push(seedPrmu + i * jobs, seedDepth[i]);
    std::vector<int16_t> perm(jobs);
    int16_t d;
    while (pool.count > 0) {
      // refresh + publish the incumbent (checkBest both ways)
      int g = sharedBest.load(std::memory_order_relaxed);
      if (g < c.best) c.best = g;
      pool.popBack(perm.data(), &d);
      ++expandedPer[t];
      expandNode(b, lbKind, perm.data(), d, c, pool);
      if (c.best < g) {
        int cur = g;
        while (c.best < cur &&
               !sharedBest.compare_exchange_weak(cur, c.best)) {
        }
      }
    }
    trees[t] = c.tree;
    sols[t] = c.sol;
  };

  std::vector<std::thread> threads;
  for (int t = 1; t < nThreads; ++t) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();

  unsigned long long tt = 0, ss = 0;
  long long expanded = 0;
  for (int t = 0; t < nThreads; ++t) {
    tt += trees[t];
    ss += sols[t];
    expanded += expandedPer[t];
  }
  *tree = tt;
  *sol = ss;
  *best = sharedBest.load();
  return expanded;
}

// Asynchronous host search session — the CONCURRENT heterogeneous tier.
// The reference's -C 1 runs CPU worker threads concurrently with the GPU
// managers, all sharing the incumbent through checkBest CAS
// (pfsp_multigpu_cuda.c:61-69, 159-263). Here the Python side drives the
// compiled device loop in segments while these native threads consume
// their own seed share; every segment boundary merges incumbents both
// ways with tts_async_best / tts_async_offer — so a bound found by
// either side prunes the other while both are still running.

namespace {

struct AsyncSearch {
  Bounds bounds;
  int lbKind;
  int nThreads;
  std::atomic<int> sharedBest;
  std::atomic<int> doneThreads{0};
  std::vector<unsigned long long> trees, sols;
  std::vector<long long> expandedPer;
  std::vector<int16_t> seedPrmu, seedDepth;  // owned copies
  long long nSeeds;
  std::vector<std::thread> threads;

  AsyncSearch(const int* p, int jobs, int machines, int lb, int initUb,
              const int16_t* sp, const int16_t* sd, long long n, int nt)
      : bounds(p, jobs, machines),
        lbKind(lb),
        nThreads(nt < 1 ? 1 : nt),
        sharedBest(initUb > 0 ? initUb : kIntMax),
        trees(nThreads, 0),
        sols(nThreads, 0),
        expandedPer(nThreads, 0),
        seedPrmu(sp, sp + n * jobs),
        seedDepth(sd, sd + n),
        nSeeds(n) {}

  void worker(int t) {
    const int jobs = bounds.jobs;
    SearchCounters c;
    c.best = sharedBest.load(std::memory_order_relaxed);
    NodeStore pool(jobs);
    for (long long i = t; i < nSeeds; i += nThreads)
      pool.push(&seedPrmu[i * jobs], seedDepth[i]);
    std::vector<int16_t> perm(jobs);
    int16_t d;
    while (pool.count > 0) {
      int g = sharedBest.load(std::memory_order_relaxed);
      if (g < c.best) c.best = g;
      pool.popBack(perm.data(), &d);
      ++expandedPer[t];
      expandNode(bounds, lbKind, perm.data(), d, c, pool);
      if (c.best < g) {
        int cur = g;
        while (c.best < cur &&
               !sharedBest.compare_exchange_weak(cur, c.best)) {
        }
      }
    }
    trees[t] = c.tree;
    sols[t] = c.sol;
    doneThreads.fetch_add(1);
  }

  void start() {
    for (int t = 0; t < nThreads; ++t)
      threads.emplace_back(&AsyncSearch::worker, this, t);
  }
};

}  // namespace

void* tts_async_start(const int* p, int jobs, int machines, int lbKind,
                      int initUb, const int16_t* seedPrmu,
                      const int16_t* seedDepth, long long nSeeds,
                      int nThreads) {
  auto* s = new AsyncSearch(p, jobs, machines, lbKind, initUb, seedPrmu,
                            seedDepth, nSeeds, nThreads);
  s->start();
  return s;
}

int tts_async_best(void* h) {
  return static_cast<AsyncSearch*>(h)->sharedBest.load();
}

// Merge an externally-found incumbent (CAS min — checkBest semantics).
void tts_async_offer(void* h, int b) {
  auto& shared = static_cast<AsyncSearch*>(h)->sharedBest;
  int cur = shared.load();
  while (b < cur && !shared.compare_exchange_weak(cur, b)) {
  }
}

int tts_async_done(void* h) {
  auto* s = static_cast<AsyncSearch*>(h);
  return s->doneThreads.load() >= s->nThreads ? 1 : 0;
}

// Join all threads, write out the summed counters, free the session.
long long tts_async_join(void* h, unsigned long long* tree,
                         unsigned long long* sol, int* best) {
  auto* s = static_cast<AsyncSearch*>(h);
  for (auto& th : s->threads) th.join();
  unsigned long long tt = 0, ss = 0;
  long long expanded = 0;
  for (int t = 0; t < s->nThreads; ++t) {
    tt += s->trees[t];
    ss += s->sols[t];
    expanded += s->expandedPer[t];
  }
  *tree = tt;
  *sol = ss;
  *best = s->sharedBest.load();
  delete s;
  return expanded;
}

// N-Queens backtracking (reference semantics: nqueens_c.c:99-148).
long long tts_nqueens(int n, int g, unsigned long long* tree,
                      unsigned long long* sol) {
  std::vector<int16_t> pool;   // SoA boards
  std::vector<int16_t> depths;
  pool.reserve(1024 * n);
  for (int i = 0; i < n; ++i) pool.push_back(static_cast<int16_t>(i));
  depths.push_back(0);
  *tree = 0;
  *sol = 0;
  std::vector<int16_t> board(n);
  long long expanded = 0;
  while (!depths.empty()) {
    int d = depths.back();
    depths.pop_back();
    std::memcpy(board.data(), &pool[(depths.size()) * n], n * sizeof(int16_t));
    pool.resize(depths.size() * n);
    ++expanded;
    if (d == n) ++(*sol);
    for (int j = d; j < n; ++j) {
      bool safe = true;
      for (int rep = 0; rep < g; ++rep)
        for (int i = 0; i < d; ++i) {
          int delta = board[i] - board[j];
          if (delta == d - i || -delta == d - i) safe = false;
        }
      if (safe) {
        size_t base = pool.size();
        pool.resize(base + n);
        std::memcpy(&pool[base], board.data(), n * sizeof(int16_t));
        std::swap(pool[base + d], pool[base + j]);
        depths.push_back(static_cast<int16_t>(d + 1));
        ++(*tree);
      }
    }
  }
  return expanded;
}

}  // extern "C"
