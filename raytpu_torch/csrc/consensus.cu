// Consensus closest-hit and any-hit sweeps (K8, K9).
//
// Replaces: raytpu/ops/mega.py::_mega_closest_kernel (:719, wrapper
// mega_closest_sweep :954) and ::_mega_anyhit_kernel (:1090, wrapper
// mega_anyhit_sweep :1216). They compute the chained sweeps' function
// (traverse.cu: the closest hit merged into the 9-plane state with strict
// t < best_t, only improved lanes written; occlusion OR-merged into occ) on
// the per-lane tier's schedule (perlane.cu: the prepass's block bitmask and
// octants, entries in stable depth order, or in the wrapper's shadow order),
// and walk as the TPU megakernel does (walk.cuh with kWarp = true):
//   - a group of lanes walks one entry's tree with ONE node pointer: every
//     lane tests the node's box, leaves included, against its own window;
//     the group descends, or tests the leaf's triangles for every lane,
//     where any lane's box hits;
//   - along the wide links (raytpu/ops/mega.py:198, TorchScene.wide_succ/
//     wide_skip): every other interior level is dropped from each octant's
//     threading, a stackless BVH4;
//   - K9's group stops once every lane is occluded.
// The TPU's group is the spp sample packets of one tile (4 x 1024 lanes);
// here it is the warp, 32 consecutive lanes (one 32-pixel row of a tile for
// one sample), with __any_sync for the vote and __all_sync for K9's exit.
// The wrapper makes the wave whole blocks of whole warps, so a warp lies
// inside one culling block and shares its bit and octant; a warp whose
// lanes are all dead returns at once. The SMEM chunk tables and their DMA,
// the VMEM double buffers, the bitmask word scan and LOCKSTEP_PACKETS are
// the TPU's scheduling and have no counterpart here.
//
// What bounds it on the H100. Its work is the box tests of every node the
// warp visits and the triangle tests of every leaf it enters, for all 32
// lanes (on config3's primary wave 7.0 visits and 19.2 tests a ray for K8);
// chip_smoke.py bounds a 256-packet slice of it at about 5 us. The
// stand-ins' trees are small (config3's packed records 3 KB,
// config2's 358 KB) and stay in L1/L2, so in practice a visit waits on its
// dependent node load, and only other warps hide that wait. The warp's
// loads are warp-uniform: one node record, read by 32 lanes at one
// address, is one broadcast request, and the warp never diverges in the
// walk. The price is box and triangle tests of lanes that would have
// culled the node.
//
// What this design does about it:
//   - packed records (walk.cuh's PackedFetch over TorchScene.packed_nodes,
//     packed_tris and the wide links packed {succ, skip} in packed_wide,
//     the block's octant row): a visit is two 16-byte node loads from one
//     32-byte sector and one 8-byte link load, issued together, so the next
//     node is in a register before the vote; a triangle test is three
//     16-byte loads. The bvh_* tables took five scalar loads a visit, the
//     link's after the vote, and nine a test.
//   - evict-first streams: rays, the state's t, tmax and occ are read, and
//     the improved state and the flags written, with __ldcs/__stcs
//     (walk.cuh's load_once, store_once), so the tree's records stay in
//     L1/L2 while the wave streams through.
//   - registers: the hit record (normal, material, instance) is made once,
//     after the walk, from the winning entry, slot and u, v, so it holds no
//     registers through the walk; __launch_bounds__(BLOCK, kMinCtas) asks
//     for 4 CTAs of 256 on an SM. rt_consensus_attributes reports the
//     registers, local bytes and resident CTAs; chip_smoke.py prints them.
// Every lane makes the same tests in the same order as before, so K8 and
// K9 still equal their plain versions bit for bit.
//
// Work counters: each kernel is a template on kCount, as K1/K2 are
// (perlane.cu). The entry points launch the counting instantiation when the
// wrapper passes a `work` buffer (four u64: the walking lanes' node visits
// and triangle tests, and those of them the lanes' own walks need,
// walk.cuh's OwnWalk; raytpu_torch/_build.py work_counts), and the one
// without, which counts nothing, otherwise. A counting warp adds its sums
// once, after its entries (rt::add_work).
//
// Rays and state are (planes, n) with `*_s` elements between planes, as in
// traverse.cu. The plain versions are
// raytpu_torch/ops/consensus.py::mega_*_sweep_ref.

#include "walk.cuh"

namespace {

// CTAs of rt::BLOCK threads that __launch_bounds__ asks to fit on one SM:
// 4 x 256 threads of the SM's 2048, at most 64 registers a thread.
constexpr int kMinCtas = 4;

template <bool kCount>
__global__ void __launch_bounds__(rt::BLOCK, kMinCtas)
    mega_closest_sweep_kernel(const float* __restrict__ rays,
                              long long rays_s, float* __restrict__ state,
                              long long st_s, long long n, float tmin,
                              rt::Schedule sc, rt::Tables tab, rt::Packed pk,
                              const float* __restrict__ n_soa,
                              long long n_tris, unsigned long long* work) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // n is whole warps: this leaves whole warps
  float bt = rt::load_once<true>(state + rt::ST_T * st_s + i);
  if (!__any_sync(rt::kFullWarp, bt > tmin)) return;  // a dead warp
  rt::Work w;

  const rt::LaneSchedule ls = rt::lane_schedule(sc, i);  // warp-uniform
  const rt::PackedFetch f = pk.at(ls.row);
  float ow[3], dw[3];
  rt::load_ray<true>(rays, rays_s, i, ow, dw);
  // the last entry that improved t, its slot and u, v
  int win_e = -1, win_s = -1;
  float win_u = 0.f, win_v = 0.f;
  for (int e = 0; e < tab.n_entries; ++e) {
    if (!ls.walks(sc, e)) continue;
    const rt::Entry en = rt::load_entry(tab, e);
    float o[3], d[3], d_inv[3];
    rt::object_ray(tab, en, ow, dw, o, d, d_inv);
    float bu = 0.f, bv = 0.f;
    const int bs = rt::closest_in_entry<true, kCount>(f, en, o, d, d_inv,
                                                      tmin, &bt, &bu, &bv, &w);
    if (bs >= 0) {
      win_e = e;
      win_s = bs;
      win_u = bu;
      win_v = bv;
    }
  }
  if constexpr (kCount) rt::add_work<4>(work, w);
  if (win_e < 0) return;
  const rt::Entry en = rt::load_entry(tab, win_e);
  rt::Hit hit;
  rt::record_hit(&hit, en, tab.w2o + 12 * en.inst, n_soa, n_tris, win_s,
                 win_u, win_v);
  rt::write_hit<true>(state, st_s, i, bt, hit);
}

template <bool kCount>
__global__ void __launch_bounds__(rt::BLOCK, kMinCtas)
    mega_anyhit_sweep_kernel(const float* __restrict__ rays,
                             long long rays_s, const float* __restrict__ tmax,
                             int* __restrict__ occ, long long n, float tmin,
                             rt::Schedule sc, rt::Tables tab, rt::Packed pk,
                             unsigned long long* work) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // n is whole warps: this leaves whole warps
  const float tm = rt::load_once<true>(tmax + i);
  // OR-merge: occluded lanes stay so
  const bool pending = rt::load_once<true>(occ + i) == 0 && tm > tmin;
  if (!__any_sync(rt::kFullWarp, pending)) return;

  const rt::LaneSchedule ls = rt::lane_schedule(sc, i);  // warp-uniform
  const rt::PackedFetch f = pk.at(ls.row);
  float ow[3], dw[3];
  rt::load_ray<true>(rays, rays_s, i, ow, dw);
  bool done = !pending;
  rt::Work w;
  for (int e = 0; e < tab.n_entries; ++e) {
    if (!ls.walks(sc, e)) continue;
    const rt::Entry en = rt::load_entry(tab, e);
    float o[3], d[3], d_inv[3];
    rt::object_ray(tab, en, ow, dw, o, d, d_inv);
    done = rt::occluded_in_entry<true, kCount>(f, en, o, d, d_inv, tmin, tm,
                                               done, &w);
    if (__all_sync(rt::kFullWarp, done)) break;  // every lane occluded
  }
  if constexpr (kCount) rt::add_work<4>(work, w);
  if (pending && done) rt::store_once<true>(occ + i, 1);
}

}  // namespace

extern "C" {

// rays (6, n) and state (9, n) f32 with plane strides, state updated in
// place; the schedule (block lanes, bits, words, octants); the packed wide
// links (8, M, 2) int32, M; the entries in walk order and w2o; the packed
// nodes (M, 8) and triangles (T, 12) f32, 16-byte aligned; the
// slot-ordered normals (9, T); work: null, or four u64 that the counting
// kernel adds its counts to. n and block_lanes are multiples of 32.
int rt_mega_closest_sweep(
    const void* rays, long long rays_s, void* state, long long st_s,
    long long n, float tmin, long long block_lanes, const void* bits,
    int n_words, const void* octs, const void* links, long long n_nodes,
    const void* entries, int n_entries, const void* w2o, const void* nodes,
    const void* tris, const void* n_soa, long long n_tris, void* work,
    void* stream) {
  if (n % 32 != 0 || block_lanes % 32 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const rt::Schedule sc = rt::make_schedule(block_lanes, bits, n_words,
                                              octs, n_nodes);
    const rt::Tables tab = rt::make_tables(entries, n_entries, w2o);
    const rt::Packed pk{(const float4*)nodes, (const int2*)links,
                        (const float4*)tris};
    const auto kernel = work ? mega_closest_sweep_kernel<true>
                             : mega_closest_sweep_kernel<false>;
    kernel<<<rt::grid_for(n), rt::BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (float*)state, st_s, n, tmin, sc, tab, pk,
        (const float*)n_soa, n_tris, (unsigned long long*)work);
  }
  return (int)cudaGetLastError();
}

// rays (6, n) f32 with a plane stride; tmax (n,) f32; occ (n,) int32
// OR-merged in place; the schedule, links, tables and work as for
// rt_mega_closest_sweep.
int rt_mega_anyhit_sweep(
    const void* rays, long long rays_s, const void* tmax, void* occ,
    long long n, float tmin, long long block_lanes, const void* bits,
    int n_words, const void* octs, const void* links, long long n_nodes,
    const void* entries, int n_entries, const void* w2o, const void* nodes,
    const void* tris, void* work, void* stream) {
  if (n % 32 != 0 || block_lanes % 32 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const rt::Schedule sc = rt::make_schedule(block_lanes, bits, n_words,
                                              octs, n_nodes);
    const rt::Tables tab = rt::make_tables(entries, n_entries, w2o);
    const rt::Packed pk{(const float4*)nodes, (const int2*)links,
                        (const float4*)tris};
    const auto kernel = work ? mega_anyhit_sweep_kernel<true>
                             : mega_anyhit_sweep_kernel<false>;
    kernel<<<rt::grid_for(n), rt::BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (int*)occ, n, tmin,
        sc, tab, pk, (unsigned long long*)work);
  }
  return (int)cudaGetLastError();
}

// K8's (anyhit 0) or K9's (1) registers and local bytes a thread (spills
// and local arrays), and the CTAs of rt::BLOCK threads resident per SM and
// the SMs, into out[0..3].
int rt_consensus_attributes(int anyhit, int* out) {
  const void* kernel = anyhit ? (const void*)mega_anyhit_sweep_kernel<false>
                              : (const void*)mega_closest_sweep_kernel<false>;
  return rt::kernel_attributes(kernel, out);
}

}  // extern "C"
