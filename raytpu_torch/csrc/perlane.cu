// Per-lane closest-hit and any-hit sweeps (K1, K2).
//
// Replaces: raytpu/ops/perlane.py::_perlane_closest_kernel (:1490, wrapper
// perlane_closest_sweep :1633) and ::_perlane_anyhit_kernel (:1720, wrapper
// perlane_anyhit_sweep :1862). They compute the chained sweeps' function
// (traverse.cu: closest hit merged into the 9-plane state with strict
// t < best_t; occlusion OR-merged into occ) with the per-lane tier's
// schedule, which is what decides exact ties:
//   - entries in the order the wrapper gives (stable depth order for the
//     closest sweep, nearest-the-light first for the shadow sweep);
//   - a lane skips an entry whose bit for the lane's block is 0 (bits:
//     (E, n_words) int32 words in walk order, bit b % 32 of word b / 32 for
//     block b = lane / block_lanes, from the prepass of ops/mega.py);
//   - inside an entry, near child first with the BLOCK's majority octant
//     (octs[b]), as the TPU kernel walks, so that ties resolve in its
//     order: the order of the octant links (raytpu/ops/mega.py:128).
// The TPU kernel's treelet gather banks, 16-bit boxes and deferred-leaf
// queue exist for its 128-entry VMEM gathers; here a thread walks f32
// records through L1/L2.
//
// What bounds it on the H100. Its work is the node visits and triangle
// tests of its lanes' walks: at 67 TFLOP/s of f32 a 256-packet slice of
// config4 needs about 8 us (chip_smoke.py's bound, operations). The tables
// of config4 (2.4 MB of nodes, 4.9 MB of child pairs, 16 MB of triangles)
// fit in the 50 MB L2. Fewer dependent loads alone did not make it faster:
// the pair records took K1's record fetches to 53% of its node visits on
// the config4 slice at the same time as the stackless walk (PERF.md,
// Findings); what did was issue: the warp's lanes doing node steps and
// leaf tests in separate loops, and the slab test in fewer instructions.
//
// What this design does about it:
//   - the pair step, as the TPU kernel's own (raytpu/ops/perlane.py:120-150,
//     _pair_step :912; the TPU tier dropped it at frame level, where a pair
//     step cost 7 VMEM gathers against 4): the walk stands at an ENTERED
//     node and loads one 64-byte record of both its children
//     (TorchScene.packed_pairs, four 16-byte words: each child's box and
//     reference, and a near-mask byte whose bit o says whether the
//     build-order first child is the near one for octant o, taken from the
//     octant links). Both children's slab tests issue together; a leaf
//     child's triangle loads issue at once from its reference. An entered
//     inner node costs one dependent fetch instead of two (each child a
//     node visit of two 16-byte words and an 8-byte link word of the
//     stackless walk), and reaching a leaf costs none. The octant links are
//     no longer read.
//   - a per-lane stack (local memory, kStack entries; the wrapper refuses a
//     deeper tree): the near child is taken next; the far one is taken
//     right after it where the near one is a leaf or missed, and pushed
//     where the near one is entered. An inner child whose box misses now
//     is never taken: the window only falls, so it would miss at its turn
//     too. A pushed inner child keeps its t_near and is entered where
//     t_near <= the window then, the comparison rt::slab would make on
//     arrival (its other half held at the push; rt::slab_near). A leaf is
//     tested on arrival with no box test (raytpu/ops/traverse.py:117-127).
//     So each lane enters the same nodes and tests the same triangles in
//     the same order as the stackless near-first walk along the octant
//     links (ops/traverse.py::_walk), which stays the plain version.
//   - while-while: a lane takes inner nodes until it reaches a leaf, then
//     tests the leaf, so a warp's lanes make their node steps together and
//     their leaf tests together, where one loop over both ran each step's
//     node and leaf paths one after the other for a warp whose lanes were
//     at both (K1's device time -26% on the config4 slice).
//   - rt::slab_near, slab's hits in fewer instructions: fminf/fmaxf and one
//     NaN test in place of NaN-propagating min/max (K1 and K2 -17 to -21%
//     more).
//   - packed records (TorchScene.packed_*): a root's record is two 16-byte
//     words of one 32-byte sector, a pair record four of one 128-byte line,
//     a triangle three 16-byte words.
//   - persistent warps: the grid is as many CTAs as fit on the card at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), and each warp
//     takes its next 32 lanes with one atomicAdd on its CTA's work counter
//     (scratch that the wrapper allocates and the entry point zeroes on the
//     stream) until the wave is taken, so a warp that finishes early walks
//     on instead of waiting for the slowest warp of its CTA. The CTAs take
//     the wave's 256-lane blocks side by side (next_chunk), as a launch of
//     one thread per lane dispatches them: one global counter that scatters
//     consecutive chunks over the SMs, or a contiguous region per CTA, made
//     both sweeps slower (PERF.md, Findings). 32 consecutive lanes lie in one
//     culling block whenever a block is whole warps (8 packets x K), so its
//     bit word and octant stay warp-uniform; each lane reads its own,
//     so any K is right.
//   - the register budget: __launch_bounds__(BLOCK, kMinCtas) caps a thread
//     at 64 registers, so 4 CTAs of 256 (50% occupancy) fit on an SM;
//     rt_perlane_attributes reports registers, local bytes (the stack
//     included) and resident CTAs, and chip_smoke.py prints them.
// K1 and K2 equal their plain versions bit for bit.
//
// Work counters: each kernel is a template on kCount. The entry points
// launch the counting instantiation when the wrapper passes a `work` buffer
// (three u64: node visits, triangle tests, record fetches;
// raytpu_torch/_build.py work_counts), and the one without, which counts
// nothing, otherwise. The visits and tests are those of the stackless walk:
// the root, then both children of each entered node as the walk reaches
// them (so an inner child whose box missed is kept as a count-only entry,
// t_near NaN, and an any-hit's early end counts what the plain walk counts),
// and one test per rt::moller_trumbore call; the fetches are one for each
// entry's root and one for each pair record loaded. A counting warp keeps
// its lanes' counts in registers over all its chunks and adds their sums
// once, after its last chunk (rt::add_counts).
//
// Rays and state are (planes, n) with `*_s` elements between planes, as in
// traverse.cu, so a wave x[:, s:s+b] goes in without a copy. The plain
// versions are raytpu_torch/ops/perlane.py::perlane_*_sweep_ref.

#include "walk.cuh"

namespace {

// CTAs of rt::BLOCK threads that __launch_bounds__ asks to fit on one SM:
// 4 x 256 threads of the SM's 2048 is 50% occupancy, at most 64 registers a
// thread.
constexpr int kMinCtas = 4;

// Where a warp takes its next 32 lanes. The wave is dealt out in blocks of
// rt::BLOCK lanes, CTA c taking blocks c, c + G, c + 2G, ... (G CTAs, as a
// one-thread-per-lane launch of G CTAs at a time would), and each CTA has a
// work counter: its warps take the 32-lane chunks of its blocks in order,
// one atomicAdd each (ticket t: block t / kChunks, chunk t % kChunks). So
// the CTAs work side by side on one stretch of the wave, which keeps the
// nodes their neighbouring rays walk in the caches, while a warp that
// finishes early takes the next chunk instead of waiting for the slowest
// warp of its CTA.
constexpr unsigned kChunks = rt::BLOCK / 32;  // chunks in a block

__device__ __forceinline__ long long next_chunk(unsigned* taken,
                                                long long n) {
  unsigned t = 0;
  if ((threadIdx.x & 31) == 0) t = atomicAdd(taken + blockIdx.x, 1u);
  t = __shfl_sync(rt::kFullWarp, t, 0);
  const long long block = blockIdx.x + (long long)(t / kChunks) * gridDim.x;
  const long long base = block * rt::BLOCK + (long long)(t % kChunks) * 32;
  return base < n ? base : -1;  // the CTA's tickets only go further on
}

// The stack's entries: it holds at most one far child for each inner level
// above the walk, so a tree of D inner levels needs D
// (raytpu_torch/ops/perlane.py PAIR_STACK; the wrapper refuses a scene whose
// TorchScene.pair_depth is larger).
constexpr int kStack = 64;

// What K1/K2 read of the tree: the packed node records (an entry's root),
// the child-pair records and the packed triangles.
struct Pairs {
  const float4* nodes;  // (M, 2) float4 {bmin, first} {bmax, count}
  // (M, 4) float4, for inner node g: {a_min, a_ref} {a_max, a_count << 8 |
  // near} {b_min, b_ref} {b_max, b_count} of its children a (row g + 1)
  // and b; a ref is a leaf's first slot (>= 0) or ~id of an inner node's
  // mesh-local id (< 0, as packed_nodes' first is -1 = ~0 for an inner
  // root); bit o of near: a is the near child for octant o
  const float4* pairs;
  const float4* tris;   // (T, 3) float4 {v0, 0} {e1, 0} {e2, 0}
};

// A lane's node visits, triangle tests and record fetches (kCount walks).
struct PairWork {
  unsigned long long nodes = 0, tests = 0, fetches = 0;
};

// A node as the walk reaches it: a leaf {first slot, count}, or an inner
// node {~id, the bits of its box's t_near when its parent was entered};
// t_near NaN (kMissed) for a box that missed then, which only a counting
// walk reaches, to count the visit the stackless walk makes.
using Item = int2;
constexpr int kMissed = 0x7fffffff;  // the bits of CUDART_NAN_F

// The node of record words lo, hi (`ref` in lo.w) with `count`, its box
// tested within (tmin, tfar).
__device__ __forceinline__ Item reach(const float4& lo, const float4& hi,
                                      int count, const float* o,
                                      const float* d_inv, float tmin,
                                      float tfar) {
  float t_near;
  const bool hit = rt::slab_near(o, d_inv, lo, hi, tmin, tfar, &t_near);
  const int ref = __float_as_int(lo.w);
  if (ref >= 0) return Item{ref, count};
  return Item{ref, hit ? __float_as_int(t_near) : kMissed};
}

// One lane's walk of entry `en` over the pair records, near child first for
// octant `oct`, box tests within (tmin, *win). leaf(first, count) tests a
// leaf's triangles (it may lower *win) and returns true to end the walk
// (an any-hit's first hit); so does the walk.
template <bool kCount, class Leaf>
__device__ __forceinline__ bool pair_walk(const Pairs& pt, int oct,
                                          const rt::Entry& en, const float* o,
                                          const float* d_inv, float tmin,
                                          const float* win, Leaf&& leaf,
                                          PairWork* work) {
  if constexpr (kCount) ++work->fetches;
  const float4 lo = __ldg(pt.nodes + 2LL * en.nb);
  const float4 hi = __ldg(pt.nodes + 2LL * en.nb + 1);
  Item it = reach(lo, hi, __float_as_int(hi.w), o, d_inv, tmin, *win);
  // the far child of an entered node whose near child is a leaf or missed:
  // reached right after the near one, with no trip through the stack
  Item next;
  bool has_next = false;
  Item stack[kStack];
  int sp = 0;
  // the node the walk reaches next, or false where the walk is done
  const auto advance = [&]() {
    if (has_next) {
      it = next;
      has_next = false;
    } else if (sp > 0) {
      it = stack[--sp];
    } else {
      return false;
    }
    return true;
  };
  for (;;) {
    // inner nodes until the walk reaches a leaf, then the leaf: a warp's
    // lanes take their node steps together and their leaves together
    while (it.x < 0) {
      if constexpr (kCount) ++work->nodes;
      if (__int_as_float(it.y) <= *win) {
        // entered: both children's record, their boxes tested now
        if constexpr (kCount) ++work->fetches;
        const float4* r = pt.pairs + 4LL * (en.nb + ~it.x);
        const float4 a_lo = __ldg(r), a_hi = __ldg(r + 1),
                     b_lo = __ldg(r + 2), b_hi = __ldg(r + 3);
        const int a_word = __float_as_int(a_hi.w);
        const Item a = reach(a_lo, a_hi, a_word >> 8, o, d_inv, tmin, *win);
        const Item b = reach(b_lo, b_hi, __float_as_int(b_hi.w), o, d_inv,
                             tmin, *win);
        const bool a_near = (a_word >> oct) & 1;
        it = a_near ? a : b;
        next = a_near ? b : a;
        // a far inner node whose box missed now would miss at its turn
        has_next = kCount || next.x >= 0 || next.y != kMissed;
        if (it.x < 0 && it.y != kMissed && has_next) {  // near one entered
          stack[sp++] = next;
          has_next = false;
        }
      } else if (!advance()) {
        return false;
      }
    }
    if constexpr (kCount) ++work->nodes;
    if (leaf(it.x, it.y)) return true;
    if (!advance()) return false;
  }
}

template <bool kCount>
__device__ __forceinline__ void closest_lane(
    long long i, const float* __restrict__ rays, long long rays_s,
    float* __restrict__ state, long long st_s, float tmin,
    const rt::Schedule& sc, const rt::Tables& tab, const Pairs& pt,
    const float* __restrict__ n_soa, long long n_tris, PairWork* work) {
  float bt = state[rt::ST_T * st_s + i];
  if (!(bt > tmin)) return;  // dead lane (window 0): never walks

  const rt::LaneSchedule ls = rt::lane_schedule(sc, i);
  const int oct = (int)ls.row;  // a schedule of rows of one: the octant
  float ow[3], dw[3];
  rt::load_ray(rays, rays_s, i, ow, dw);
  // the last entry that improved t, its slot and u, v: the hit record
  // (normal, material, instance) is made once, after the walk, so that it
  // holds no registers through it
  int win_e = -1, win_s = -1;
  float win_u = 0.f, win_v = 0.f;
  for (int e = 0; e < tab.n_entries; ++e) {
    if (!ls.walks(sc, e)) continue;
    const rt::Entry en = rt::load_entry(tab, e);
    float o[3], d[3], d_inv[3];
    rt::object_ray(tab, en, ow, dw, o, d, d_inv);
    int bs = -1;
    float bu = 0.f, bv = 0.f;
    pair_walk<kCount>(
        pt, oct, en, o, d_inv, tmin, &bt,
        [&](int first, int cnt) {
          for (int k = 0; k < cnt; ++k) {
            const long long s = (long long)en.tb + first + k;
            if constexpr (kCount) ++work->tests;
            float t, u, v;
            if (rt::packed_test(pt.tris, s, o, d, tmin, bt, &t, &u, &v)) {
              bt = t;
              bs = (int)s;
              bu = u;
              bv = v;
            }
          }
          return false;
        },
        work);
    if (bs >= 0) {
      win_e = e;
      win_s = bs;
      win_u = bu;
      win_v = bv;
    }
  }
  if (win_e < 0) return;
  const rt::Entry en = rt::load_entry(tab, win_e);
  rt::Hit hit;
  rt::record_hit(&hit, en, tab.w2o + 12 * en.inst, n_soa, n_tris, win_s,
                 win_u, win_v);
  rt::write_hit(state, st_s, i, bt, hit);
}

template <bool kCount>
__device__ __forceinline__ void anyhit_lane(
    long long i, const float* __restrict__ rays, long long rays_s,
    const float* __restrict__ tmax, int* __restrict__ occ, float tmin,
    const rt::Schedule& sc, const rt::Tables& tab, const Pairs& pt,
    PairWork* work) {
  if (occ[i] != 0) return;  // OR-merge: already occluded
  const float tm = tmax[i];
  if (!(tm > tmin)) return;

  const rt::LaneSchedule ls = rt::lane_schedule(sc, i);
  const int oct = (int)ls.row;
  float ow[3], dw[3];
  rt::load_ray(rays, rays_s, i, ow, dw);
  for (int e = 0; e < tab.n_entries; ++e) {
    if (!ls.walks(sc, e)) continue;
    const rt::Entry en = rt::load_entry(tab, e);
    float o[3], d[3], d_inv[3];
    rt::object_ray(tab, en, ow, dw, o, d, d_inv);
    const bool hit = pair_walk<kCount>(
        pt, oct, en, o, d_inv, tmin, &tm,
        [&](int first, int cnt) {
          for (int k = 0; k < cnt; ++k) {
            const long long s = (long long)en.tb + first + k;
            if constexpr (kCount) ++work->tests;
            float t, u, v;
            if (rt::packed_test(pt.tris, s, o, d, tmin, tm, &t, &u, &v))
              return true;
          }
          return false;
        },
        work);
    if (hit) {
      occ[i] = 1;  // first hit ends the lane's whole sweep
      return;
    }
  }
}

template <bool kCount>
__device__ __forceinline__ void add_pair_work(unsigned long long* out,
                                              const PairWork& w) {
  if constexpr (kCount) {
    unsigned long long v[3] = {w.nodes, w.tests, w.fetches};
    rt::add_counts<3>(out, v);
  }
}

// Persistent warps: each takes 32 lanes at a time until the wave is done
// (the chunk loop is warp-uniform, so a warp leaves it converged).
template <bool kCount>
__global__ void __launch_bounds__(rt::BLOCK, kMinCtas)
    perlane_closest_sweep_kernel(const float* __restrict__ rays,
                                 long long rays_s, float* __restrict__ state,
                                 long long st_s, long long n, float tmin,
                                 rt::Schedule sc, rt::Tables tab, Pairs pt,
                                 const float* __restrict__ n_soa,
                                 long long n_tris, unsigned* taken,
                                 unsigned long long* work) {
  PairWork w;
  for (long long base; (base = next_chunk(taken, n)) >= 0;) {
    const long long i = base + (threadIdx.x & 31);
    if (i < n)
      closest_lane<kCount>(i, rays, rays_s, state, st_s, tmin, sc, tab, pt,
                           n_soa, n_tris, &w);
  }
  add_pair_work<kCount>(work, w);
}

template <bool kCount>
__global__ void __launch_bounds__(rt::BLOCK, kMinCtas)
    perlane_anyhit_sweep_kernel(const float* __restrict__ rays,
                                long long rays_s,
                                const float* __restrict__ tmax,
                                int* __restrict__ occ, long long n,
                                float tmin, rt::Schedule sc, rt::Tables tab,
                                Pairs pt, unsigned* taken,
                                unsigned long long* work) {
  PairWork w;
  for (long long base; (base = next_chunk(taken, n)) >= 0;) {
    const long long i = base + (threadIdx.x & 31);
    if (i < n)
      anyhit_lane<kCount>(i, rays, rays_s, tmax, occ, tmin, sc, tab, pt, &w);
  }
  add_pair_work<kCount>(work, w);
}

// How many CTAs of `kernel` fit on the card at once.
struct Residency {
  int per_sm = 0, sms = 0;
  explicit Residency(const void* kernel) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, rt::BLOCK,
                                                  0);
  }
};

template <bool kCount>
const Residency& closest_residency() {
  static const Residency r((const void*)perlane_closest_sweep_kernel<kCount>);
  return r;
}

template <bool kCount>
const Residency& anyhit_residency() {
  static const Residency r((const void*)perlane_anyhit_sweep_kernel<kCount>);
  return r;
}

// A persistent launch of n lanes: as many CTAs as fit on the card (no more
// than the wave's blocks or the `slots` work counters), the counters zeroed
// on the stream.
struct Launch {
  int grid = 0;
  cudaError_t err = cudaSuccess;

  Launch(const Residency& res, long long n, void* taken, int slots,
         void* stream) {
    long long g = (long long)res.per_sm * res.sms;
    const long long need = (n + rt::BLOCK - 1) / rt::BLOCK;
    if (g > need) g = need;
    if (g > slots) g = slots;
    grid = (int)g;
    err = cudaMemsetAsync(taken, 0, g * sizeof(unsigned),
                          (cudaStream_t)stream);
  }
};

constexpr long long kMaxLanes = 1LL << 31;  // lane indices stay in int

}  // namespace

extern "C" {

// rays (6, n) and state (9, n) f32 with plane strides, state updated in
// place; the schedule (block lanes, bits, words, octants); the entries in
// walk order and w2o; the packed nodes (M, 8), child pairs (M, 16) and
// triangles (T, 12) f32, 16-byte aligned; the slot-ordered normals (9, T);
// taken: `slots` u32 of scratch, the CTAs' work counters; work: null, or
// three u64 that the counting kernel adds its node visits, triangle tests
// and record fetches to.
int rt_perlane_closest_sweep(
    const void* rays, long long rays_s, void* state, long long st_s,
    long long n, float tmin, long long block_lanes, const void* bits,
    int n_words, const void* octs, const void* entries, int n_entries,
    const void* w2o, const void* nodes, const void* pairs, const void* tris,
    const void* n_soa, long long n_tris, void* taken, int slots, void* work,
    void* stream) {
  if (n >= kMaxLanes) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Launch ln(
        work ? closest_residency<true>() : closest_residency<false>(), n,
        taken, slots, stream);
    if (ln.err != cudaSuccess) return (int)ln.err;
    const rt::Schedule sc = rt::make_schedule(block_lanes, bits, n_words,
                                              octs, 1);
    const rt::Tables tab = rt::make_tables(entries, n_entries, w2o);
    const Pairs pt{(const float4*)nodes, (const float4*)pairs,
                   (const float4*)tris};
    const auto kernel = work ? perlane_closest_sweep_kernel<true>
                             : perlane_closest_sweep_kernel<false>;
    kernel<<<ln.grid, rt::BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (float*)state, st_s, n, tmin, sc, tab, pt,
        (const float*)n_soa, n_tris, (unsigned*)taken,
        (unsigned long long*)work);
  }
  return (int)cudaGetLastError();
}

// rays (6, n) f32 with a plane stride; tmax (n,) f32; occ (n,) int32
// OR-merged in place; the schedule, tables, taken and work as for
// rt_perlane_closest_sweep.
int rt_perlane_anyhit_sweep(
    const void* rays, long long rays_s, const void* tmax, void* occ,
    long long n, float tmin, long long block_lanes, const void* bits,
    int n_words, const void* octs, const void* entries, int n_entries,
    const void* w2o, const void* nodes, const void* pairs, const void* tris,
    void* taken, int slots, void* work, void* stream) {
  if (n >= kMaxLanes) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Launch ln(work ? anyhit_residency<true>() : anyhit_residency<false>(),
                    n, taken, slots, stream);
    if (ln.err != cudaSuccess) return (int)ln.err;
    const rt::Schedule sc = rt::make_schedule(block_lanes, bits, n_words,
                                              octs, 1);
    const rt::Tables tab = rt::make_tables(entries, n_entries, w2o);
    const Pairs pt{(const float4*)nodes, (const float4*)pairs,
                   (const float4*)tris};
    const auto kernel = work ? perlane_anyhit_sweep_kernel<true>
                             : perlane_anyhit_sweep_kernel<false>;
    kernel<<<ln.grid, rt::BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (int*)occ, n, tmin,
        sc, tab, pt, (unsigned*)taken, (unsigned long long*)work);
  }
  return (int)cudaGetLastError();
}

// K1's (anyhit 0) or K2's (1) registers and local bytes a thread (spills
// and local arrays), and the CTAs of rt::BLOCK threads resident per SM and
// the SMs, into out[0..3].
int rt_perlane_attributes(int anyhit, int* out) {
  const void* kernel =
      anyhit ? (const void*)perlane_anyhit_sweep_kernel<false>
             : (const void*)perlane_closest_sweep_kernel<false>;
  return rt::kernel_attributes(kernel, out);
}

}  // extern "C"
