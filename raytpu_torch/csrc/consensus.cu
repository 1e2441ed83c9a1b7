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
// What bounds it on the H100: the walk's dependent node loads, as in
// perlane.cu. The design's point is that they are warp-uniform: one node
// record, read by 32 lanes at one address, is one broadcast load, and the
// warp never diverges in the walk. The price is box and triangle tests of
// lanes that would have culled the node. What this first version does
// beyond that: nothing (no shared-memory staging, no occupancy tuning).
//
// Rays and state are (planes, n) with `*_s` elements between planes, as in
// traverse.cu. The plain versions are
// raytpu_torch/ops/consensus.py::mega_*_sweep_ref.

#include "walk.cuh"

namespace {

__global__ void mega_closest_sweep_kernel(const float* __restrict__ rays,
                                          long long rays_s,
                                          float* __restrict__ state,
                                          long long st_s, long long n,
                                          float tmin, rt::Schedule sc,
                                          const int* __restrict__ succ,
                                          const int* __restrict__ skip,
                                          rt::Tables tab,
                                          const float* __restrict__ n_soa,
                                          long long n_tris) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // n is whole warps: this leaves whole warps
  float bt = state[rt::ST_T * st_s + i];
  if (!__any_sync(rt::kFullWarp, bt > tmin)) return;  // a dead warp

  const rt::LaneSchedule ls = rt::lane_schedule(sc, i);  // warp-uniform
  float ow[3], dw[3];
  rt::load_ray(rays, rays_s, i, ow, dw);
  rt::Hit hit;
  for (int e = 0; e < tab.n_entries; ++e) {
    if (!ls.walks(sc, e)) continue;
    const rt::Entry en = rt::load_entry(tab, e);
    float o[3], d[3], d_inv[3];
    const float* m = rt::object_ray(tab, en, ow, dw, o, d, d_inv);
    float bu = 0.f, bv = 0.f;
    const int bs = rt::closest_in_entry<true>(
        rt::SoaFetch{tab, succ + ls.row, skip + ls.row}, en, o, d, d_inv, tmin,
        &bt, &bu, &bv);
    if (bs >= 0) rt::record_hit(&hit, en, m, n_soa, n_tris, bs, bu, bv);
  }
  if (hit.improved) rt::write_hit(state, st_s, i, bt, hit);
}

__global__ void mega_anyhit_sweep_kernel(const float* __restrict__ rays,
                                         long long rays_s,
                                         const float* __restrict__ tmax,
                                         int* __restrict__ occ, long long n,
                                         float tmin, rt::Schedule sc,
                                         const int* __restrict__ succ,
                                         const int* __restrict__ skip,
                                         rt::Tables tab) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // n is whole warps: this leaves whole warps
  const float tm = tmax[i];
  const bool pending = occ[i] == 0 && tm > tmin;  // OR-merge: occluded stay
  if (!__any_sync(rt::kFullWarp, pending)) return;

  const rt::LaneSchedule ls = rt::lane_schedule(sc, i);  // warp-uniform
  float ow[3], dw[3];
  rt::load_ray(rays, rays_s, i, ow, dw);
  bool done = !pending;
  for (int e = 0; e < tab.n_entries; ++e) {
    if (!ls.walks(sc, e)) continue;
    const rt::Entry en = rt::load_entry(tab, e);
    float o[3], d[3], d_inv[3];
    rt::object_ray(tab, en, ow, dw, o, d, d_inv);
    done = rt::occluded_in_entry<true>(
        rt::SoaFetch{tab, succ + ls.row, skip + ls.row}, en, o, d, d_inv, tmin,
        tm, done);
    if (__all_sync(rt::kFullWarp, done)) break;  // every lane occluded
  }
  if (pending && done) occ[i] = 1;
}

}  // namespace

extern "C" {

// rays (6, n) and state (9, n) f32 with plane strides, state updated in
// place; the schedule (block lanes, bits, words, octants) with the wide
// links succ/skip (8, M) int32; the bvh_* tables, the entries in walk
// order. n and block_lanes are multiples of 32.
int rt_mega_closest_sweep(
    const void* rays, long long rays_s, void* state, long long st_s,
    long long n, float tmin, long long block_lanes, const void* bits,
    int n_words, const void* octs, const void* succ, const void* skip,
    long long n_nodes, const void* entries, int n_entries, const void* w2o,
    const void* bmin, const void* bmax, const void* first, const void* count,
    const void* miss, const void* v0, const void* e1, const void* e2,
    const void* n_soa, long long n_tris, void* stream) {
  if (n % 32 != 0 || block_lanes % 32 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    rt::Schedule sc = rt::make_schedule(block_lanes, bits, n_words, octs,
                                        n_nodes);
    rt::Tables tab = rt::make_tables(entries, n_entries, w2o, bmin, bmax,
                                     first, count, miss, v0, e1, e2);
    mega_closest_sweep_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                                (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (float*)state, st_s, n, tmin, sc,
        (const int*)succ, (const int*)skip, tab,
        (const float*)n_soa, n_tris);
  }
  return (int)cudaGetLastError();
}

// rays (6, n) f32 with a plane stride; tmax (n,) f32; occ (n,) int32
// OR-merged in place; the schedule and tables as for rt_mega_closest_sweep.
int rt_mega_anyhit_sweep(
    const void* rays, long long rays_s, const void* tmax, void* occ,
    long long n, float tmin, long long block_lanes, const void* bits,
    int n_words, const void* octs, const void* succ, const void* skip,
    long long n_nodes, const void* entries, int n_entries, const void* w2o,
    const void* bmin, const void* bmax, const void* first, const void* count,
    const void* miss, const void* v0, const void* e1, const void* e2,
    void* stream) {
  if (n % 32 != 0 || block_lanes % 32 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    rt::Schedule sc = rt::make_schedule(block_lanes, bits, n_words, octs,
                                        n_nodes);
    rt::Tables tab = rt::make_tables(entries, n_entries, w2o, bmin, bmax,
                                     first, count, miss, v0, e1, e2);
    mega_anyhit_sweep_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                               (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (int*)occ, n, tmin,
        sc, (const int*)succ, (const int*)skip, tab);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
