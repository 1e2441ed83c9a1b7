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
//   - inside an entry, walk.cuh's walk near child first along the links of
//     the BLOCK's majority octant (octs[b]), as the TPU kernel walks, so
//     that ties resolve in its order.
// The TPU kernel's treelet gather banks, 16-bit boxes, pair step and
// deferred-leaf queue exist for its 128-entry VMEM gathers; here a thread
// walks f32 records through L1/L2.
//
// What bounds it on the H100. Its work is the node visits and triangle
// tests of its lanes' walks: at 67 TFLOP/s of f32 a 256-packet slice of
// config4 needs about 8 us (chip_smoke.py's bound, operations). In
// practice a walk is a chain of dependent loads, each node's address taken
// from the node before, so a lane waits one L1/L2 round trip per step; the
// tables of config4 (2.4 MB of nodes, 4.9 MB of links, 16 MB of triangles)
// fit in the 50 MB L2, so more bandwidth would not help, fewer and wider
// requests and more of them in flight would.
//
// What this design does about it:
//   - packed records (TorchScene.packed_*, walk.cuh's PackedFetch): a node
//     visit is two 16-byte loads from one 32-byte sector and one 8-byte
//     link load, issued together; a triangle test three 16-byte loads. The
//     bvh_* tables would take nine scalar loads from five arrays a visit
//     and nine from three arrays a test, each split into up to 32 requests
//     on a divergent warp.
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
//     bit word and octant row stay warp-uniform; each lane reads its own,
//     so any K is right.
//   - the register budget: __launch_bounds__(BLOCK, kMinCtas) caps a thread
//     at 64 registers, so 4 CTAs of 256 (50% occupancy) fit on an SM;
//     rt_perlane_attributes reports registers, local bytes and resident
//     CTAs, and chip_smoke.py prints them.
// Each lane walks exactly as before (the same entries, nodes and tests in
// the same order, the same float operations), so K1 and K2 still equal
// their plain versions bit for bit.
//
// Work counters: each kernel is a template on kCount. The entry points
// launch the counting instantiation when the wrapper passes a `work` buffer
// (two u64: node visits, triangle tests; raytpu_torch/_build.py
// work_counts), and the one without, which counts nothing, otherwise. A
// counting warp keeps its lanes' counts in registers over all its chunks
// and adds their sums once, after its last chunk (rt::add_work).
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

template <bool kCount>
__device__ __forceinline__ void closest_lane(
    long long i, const float* __restrict__ rays, long long rays_s,
    float* __restrict__ state, long long st_s, float tmin,
    const rt::Schedule& sc, const rt::Tables& tab, const rt::Packed& pk,
    const float* __restrict__ n_soa, long long n_tris, rt::Work* work) {
  float bt = state[rt::ST_T * st_s + i];
  if (!(bt > tmin)) return;  // dead lane (window 0): never walks

  const rt::LaneSchedule ls = rt::lane_schedule(sc, i);
  const rt::PackedFetch f = pk.at(ls.row);
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
    float bu = 0.f, bv = 0.f;
    const int bs = rt::closest_in_entry<false, kCount>(
        f, en, o, d, d_inv, tmin, &bt, &bu, &bv, work);
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
    const rt::Schedule& sc, const rt::Tables& tab, const rt::Packed& pk,
    rt::Work* work) {
  if (occ[i] != 0) return;  // OR-merge: already occluded
  const float tm = tmax[i];
  if (!(tm > tmin)) return;

  const rt::LaneSchedule ls = rt::lane_schedule(sc, i);
  const rt::PackedFetch f = pk.at(ls.row);
  float ow[3], dw[3];
  rt::load_ray(rays, rays_s, i, ow, dw);
  for (int e = 0; e < tab.n_entries; ++e) {
    if (!ls.walks(sc, e)) continue;
    const rt::Entry en = rt::load_entry(tab, e);
    float o[3], d[3], d_inv[3];
    rt::object_ray(tab, en, ow, dw, o, d, d_inv);
    if (rt::occluded_in_entry<false, kCount>(f, en, o, d, d_inv, tmin, tm,
                                             false, work)) {
      occ[i] = 1;  // first hit ends the lane's whole sweep
      return;
    }
  }
}

// Persistent warps: each takes 32 lanes at a time until the wave is done
// (the chunk loop is warp-uniform, so a warp leaves it converged).
template <bool kCount>
__global__ void __launch_bounds__(rt::BLOCK, kMinCtas)
    perlane_closest_sweep_kernel(const float* __restrict__ rays,
                                 long long rays_s, float* __restrict__ state,
                                 long long st_s, long long n, float tmin,
                                 rt::Schedule sc, rt::Tables tab, rt::Packed pk,
                                 const float* __restrict__ n_soa,
                                 long long n_tris, unsigned* taken,
                                 unsigned long long* work) {
  rt::Work w;
  for (long long base; (base = next_chunk(taken, n)) >= 0;) {
    const long long i = base + (threadIdx.x & 31);
    if (i < n)
      closest_lane<kCount>(i, rays, rays_s, state, st_s, tmin, sc, tab, pk,
                           n_soa, n_tris, &w);
  }
  if constexpr (kCount) rt::add_work(work, w);
}

template <bool kCount>
__global__ void __launch_bounds__(rt::BLOCK, kMinCtas)
    perlane_anyhit_sweep_kernel(const float* __restrict__ rays,
                                long long rays_s,
                                const float* __restrict__ tmax,
                                int* __restrict__ occ, long long n,
                                float tmin, rt::Schedule sc, rt::Tables tab,
                                rt::Packed pk, unsigned* taken,
                                unsigned long long* work) {
  rt::Work w;
  for (long long base; (base = next_chunk(taken, n)) >= 0;) {
    const long long i = base + (threadIdx.x & 31);
    if (i < n)
      anyhit_lane<kCount>(i, rays, rays_s, tmax, occ, tmin, sc, tab, pk, &w);
  }
  if constexpr (kCount) rt::add_work(work, w);
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
// place; the schedule (block lanes, bits, words, octants); the links
// (8, M, 2) int32; the entries in walk order and w2o; the packed nodes
// (M, 8) and triangles (T, 12) f32, 16-byte aligned; the slot-ordered
// normals (9, T); taken: `slots` u32 of scratch, the CTAs' work
// counters; work: null, or two u64 that the counting kernel adds its node
// visits and triangle tests to.
int rt_perlane_closest_sweep(
    const void* rays, long long rays_s, void* state, long long st_s,
    long long n, float tmin, long long block_lanes, const void* bits,
    int n_words, const void* octs, const void* links, long long n_nodes,
    const void* entries, int n_entries, const void* w2o, const void* nodes,
    const void* tris, const void* n_soa, long long n_tris, void* taken,
    int slots, void* work, void* stream) {
  if (n >= kMaxLanes) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Launch ln(
        work ? closest_residency<true>() : closest_residency<false>(), n,
        taken, slots, stream);
    if (ln.err != cudaSuccess) return (int)ln.err;
    rt::Schedule sc = rt::make_schedule(block_lanes, bits, n_words, octs,
                                        n_nodes);
    const rt::Tables tab = rt::make_tables(entries, n_entries, w2o);
    const rt::Packed pk{(const float4*)nodes, (const int2*)links,
                        (const float4*)tris};
    const auto kernel = work ? perlane_closest_sweep_kernel<true>
                             : perlane_closest_sweep_kernel<false>;
    kernel<<<ln.grid, rt::BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (float*)state, st_s, n, tmin, sc, tab, pk,
        (const float*)n_soa, n_tris, (unsigned*)taken,
        (unsigned long long*)work);
  }
  return (int)cudaGetLastError();
}

// rays (6, n) f32 with a plane stride; tmax (n,) f32; occ (n,) int32
// OR-merged in place; the schedule, links, tables, taken and work as for
// rt_perlane_closest_sweep.
int rt_perlane_anyhit_sweep(
    const void* rays, long long rays_s, const void* tmax, void* occ,
    long long n, float tmin, long long block_lanes, const void* bits,
    int n_words, const void* octs, const void* links, long long n_nodes,
    const void* entries, int n_entries, const void* w2o, const void* nodes,
    const void* tris, void* taken, int slots, void* work, void* stream) {
  if (n >= kMaxLanes) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Launch ln(work ? anyhit_residency<true>() : anyhit_residency<false>(),
                    n, taken, slots, stream);
    if (ln.err != cudaSuccess) return (int)ln.err;
    rt::Schedule sc = rt::make_schedule(block_lanes, bits, n_words, octs,
                                        n_nodes);
    const rt::Tables tab = rt::make_tables(entries, n_entries, w2o);
    const rt::Packed pk{(const float4*)nodes, (const int2*)links,
                        (const float4*)tris};
    const auto kernel = work ? perlane_anyhit_sweep_kernel<true>
                             : perlane_anyhit_sweep_kernel<false>;
    kernel<<<ln.grid, rt::BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (int*)occ, n, tmin,
        sc, tab, pk, (unsigned*)taken, (unsigned long long*)work);
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
