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
// reads the f32 bvh_* nodes and the (8, M) link tables through L1/L2.
//
// What bounds it on the H100: the dependent node loads of the walk, as in
// traverse.cu; near-first order and block culling cut the nodes a ray
// visits. A block is 8 packets (8192 lanes at K = 1024), so a CTA's 256
// threads share their block's bit word and octant: culling does not split a
// warp. What this first version does about the loads: nothing yet (one
// thread per ray, no shared-memory staging).
//
// Rays and state are (planes, n) with `*_s` elements between planes, as in
// traverse.cu, so a wave x[:, s:s+b] goes in without a copy. The plain
// versions are raytpu_torch/ops/perlane.py::perlane_*_sweep_ref.

#include "walk.cuh"

namespace {

__global__ void perlane_closest_sweep_kernel(const float* __restrict__ rays,
                                             long long rays_s,
                                             float* __restrict__ state,
                                             long long st_s, long long n,
                                             float tmin, rt::Schedule sc,
                                             rt::Tables tab,
                                             const float* __restrict__ n_soa,
                                             long long n_tris) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bt = state[rt::ST_T * st_s + i];
  if (!(bt > tmin)) return;  // dead lane (window 0): never walks

  const rt::LaneSchedule ls = rt::lane_schedule(sc, i);
  float ow[3], dw[3];
  rt::load_ray(rays, rays_s, i, ow, dw);
  rt::Hit hit;
  for (int e = 0; e < tab.n_entries; ++e) {
    if (!ls.walks(sc, e)) continue;
    const rt::Entry en = rt::load_entry(tab, e);
    float o[3], d[3], d_inv[3];
    const float* m = rt::object_ray(tab, en, ow, dw, o, d, d_inv);
    float bu = 0.f, bv = 0.f;
    const int bs = rt::closest_in_entry<false>(tab, en, ls.succ, ls.skip, o,
                                               d, d_inv, tmin, &bt, &bu, &bv);
    if (bs >= 0) rt::record_hit(&hit, en, m, n_soa, n_tris, bs, bu, bv);
  }
  if (hit.improved) rt::write_hit(state, st_s, i, bt, hit);
}

__global__ void perlane_anyhit_sweep_kernel(const float* __restrict__ rays,
                                            long long rays_s,
                                            const float* __restrict__ tmax,
                                            int* __restrict__ occ,
                                            long long n, float tmin,
                                            rt::Schedule sc, rt::Tables tab) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (occ[i] != 0) return;  // OR-merge: already occluded
  const float tm = tmax[i];
  if (!(tm > tmin)) return;

  const rt::LaneSchedule ls = rt::lane_schedule(sc, i);
  float ow[3], dw[3];
  rt::load_ray(rays, rays_s, i, ow, dw);
  for (int e = 0; e < tab.n_entries; ++e) {
    if (!ls.walks(sc, e)) continue;
    const rt::Entry en = rt::load_entry(tab, e);
    float o[3], d[3], d_inv[3];
    rt::object_ray(tab, en, ow, dw, o, d, d_inv);
    if (rt::occluded_in_entry<false>(tab, en, ls.succ, ls.skip, o, d, d_inv,
                                     tmin, tm, false)) {
      occ[i] = 1;  // first hit ends the lane's whole sweep
      return;
    }
  }
}

}  // namespace

extern "C" {

// rays (6, n) and state (9, n) f32 with plane strides, state updated in
// place; the schedule; the tables with the entries in walk order.
int rt_perlane_closest_sweep(
    const void* rays, long long rays_s, void* state, long long st_s,
    long long n, float tmin, long long block_lanes, const void* bits,
    int n_words, const void* octs, const void* succ, const void* skip,
    long long n_nodes, const void* entries, int n_entries, const void* w2o,
    const void* bmin, const void* bmax, const void* first, const void* count,
    const void* miss, const void* v0, const void* e1, const void* e2,
    const void* n_soa, long long n_tris, void* stream) {
  if (n > 0) {
    rt::Schedule sc = rt::make_schedule(block_lanes, bits, n_words, octs,
                                        succ, skip, n_nodes);
    rt::Tables tab = rt::make_tables(entries, n_entries, w2o, bmin, bmax,
                                     first, count, miss, v0, e1, e2);
    perlane_closest_sweep_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                                   (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (float*)state, st_s, n, tmin, sc, tab,
        (const float*)n_soa, n_tris);
  }
  return (int)cudaGetLastError();
}

// rays (6, n) f32 with a plane stride; tmax (n,) f32; occ (n,) int32
// OR-merged in place; the schedule; the tables, entries in walk order.
int rt_perlane_anyhit_sweep(
    const void* rays, long long rays_s, const void* tmax, void* occ,
    long long n, float tmin, long long block_lanes, const void* bits,
    int n_words, const void* octs, const void* succ, const void* skip,
    long long n_nodes, const void* entries, int n_entries, const void* w2o,
    const void* bmin, const void* bmax, const void* first, const void* count,
    const void* miss, const void* v0, const void* e1, const void* e2,
    void* stream) {
  if (n > 0) {
    rt::Schedule sc = rt::make_schedule(block_lanes, bits, n_words, octs,
                                        succ, skip, n_nodes);
    rt::Tables tab = rt::make_tables(entries, n_entries, w2o, bmin, bmax,
                                     first, count, miss, v0, e1, e2);
    perlane_anyhit_sweep_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                                  (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (int*)occ, n, tmin,
        sc, tab);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
