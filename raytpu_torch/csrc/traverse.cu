// Closest-hit and any-hit sweeps over every (instance, mesh) entry.
//
// Replaces: raytpu/ops/traverse_pallas.py::_closest_kernel3 (:504, wrapper
// pallas_closest_chain :657) and ::_anyhit_kernel3 (:693, wrapper
// pallas_anyhit_chain :770). The TPU runs one pallas_call per entry, and in
// it one packet of 1024 rays walks the skip links with a scalar node pointer.
// Here ONE launch covers all entries, and each thread walks its own ray
// through the entries in traversal_list order: the function of
// raytpu/ops/traverse.py:78 (bvh_closest) and :149 (bvh_anyhit), merged into
// the packed 9-plane state exactly as the chained kernel merges it.
//
// The walk of one entry is walk.cuh's, in build order (node + 1 on a box
// hit, bvh_miss otherwise). The plain version closest_sweep_ref /
// anyhit_sweep_ref in raytpu_torch/ops/traverse.py makes the same tests in
// the same order, so the two agree bit for bit.
//
// What bounds it on the H100: dependent loads. Each step of a walk reads a
// node record whose address comes from the step before (miss link or i+1),
// so a thread waits one memory latency per node, and the threads of a warp
// diverge as their rays take different paths.
//
// What this first version does about it: nothing yet. Right and simple
// first: one thread per ray, tables read straight from device memory
// through the L1/L2 caches, no packet sharing, no shared-memory staging.
//
// Rays and state are (planes, n) with `*_s` elements between planes, so the
// bounce loop hands over a wave x[:, s:s+b] of its (planes, P, K) buffers
// without a copy; the lanes of a plane are contiguous.

#include "walk.cuh"

namespace {

__global__ void closest_sweep_kernel(const float* __restrict__ rays,
                                     long long rays_s,
                                     float* __restrict__ state,
                                     long long st_s, long long n,
                                     float tmin, rt::Tables tab,
                                     const float* __restrict__ n_soa,
                                     long long n_tris) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bt = state[rt::ST_T * st_s + i];
  if (!(bt > tmin)) return;  // dead lane (window 0): never walks

  float ow[3], dw[3];
  rt::load_ray(rays, rays_s, i, ow, dw);
  rt::Hit hit;
  for (int e = 0; e < tab.n_entries; ++e) {
    const rt::Entry en = rt::load_entry(tab, e);
    float o[3], d[3], d_inv[3];
    const float* m = rt::object_ray(tab, en, ow, dw, o, d, d_inv);
    float bu = 0.f, bv = 0.f;
    const int bs = rt::closest_in_entry<false>(tab, en, nullptr, tab.miss, o,
                                               d, d_inv, tmin, &bt, &bu, &bv);
    if (bs >= 0) rt::record_hit(&hit, en, m, n_soa, n_tris, bs, bu, bv);
  }
  if (hit.improved) rt::write_hit(state, st_s, i, bt, hit);
}

__global__ void anyhit_sweep_kernel(const float* __restrict__ rays,
                                    long long rays_s,
                                    const float* __restrict__ tmax,
                                    int* __restrict__ occ, long long n,
                                    float tmin, rt::Tables tab) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (occ[i] != 0) return;  // OR-merge: already occluded
  const float tm = tmax[i];
  if (!(tm > tmin)) return;

  float ow[3], dw[3];
  rt::load_ray(rays, rays_s, i, ow, dw);
  for (int e = 0; e < tab.n_entries; ++e) {
    const rt::Entry en = rt::load_entry(tab, e);
    float o[3], d[3], d_inv[3];
    rt::object_ray(tab, en, ow, dw, o, d, d_inv);
    if (rt::occluded_in_entry<false>(tab, en, nullptr, tab.miss, o, d, d_inv,
                                     tmin, tm, false)) {
      occ[i] = 1;  // first hit ends the lane's whole sweep
      return;
    }
  }
}

}  // namespace

extern "C" {

// rays (6, n) f32 and state (9, n) f32, updated in place, with plane strides.
int rt_closest_sweep(const void* rays, long long rays_s, void* state,
                     long long st_s, long long n, float tmin,
                     const void* entries, int n_entries, const void* w2o,
                     const void* bmin, const void* bmax, const void* first,
                     const void* count, const void* miss, const void* v0,
                     const void* e1, const void* e2, const void* n_soa,
                     long long n_tris, void* stream) {
  if (n > 0) {
    rt::Tables tab = rt::make_tables(entries, n_entries, w2o, bmin, bmax,
                                     first, count, miss, v0, e1, e2);
    closest_sweep_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                           (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (float*)state, st_s, n, tmin, tab,
        (const float*)n_soa, n_tris);
  }
  return (int)cudaGetLastError();
}

// rays (6, n) f32 with a plane stride; tmax (n,) f32; occ (n,) int32
// OR-merged in place.
int rt_anyhit_sweep(const void* rays, long long rays_s, const void* tmax,
                    void* occ, long long n, float tmin, const void* entries,
                    int n_entries, const void* w2o, const void* bmin,
                    const void* bmax, const void* first, const void* count,
                    const void* miss, const void* v0, const void* e1,
                    const void* e2, void* stream) {
  if (n > 0) {
    rt::Tables tab = rt::make_tables(entries, n_entries, w2o, bmin, bmax,
                                     first, count, miss, v0, e1, e2);
    anyhit_sweep_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                          (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (int*)occ, n, tmin,
        tab);
  }
  return (int)cudaGetLastError();
}

const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
