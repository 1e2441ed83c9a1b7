// Closest-hit and any-hit sweeps over every (instance, mesh) entry (K10a,
// K10b), and the one-mesh walks of the per-(instance, mesh) loop (K11a,
// K11b, below).
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
    const int bs = rt::closest_in_entry<false>(
        rt::SoaFetch{tab, nullptr, tab.miss}, en, o, d, d_inv, tmin, &bt, &bu,
        &bv);
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
    if (rt::occluded_in_entry<false>(rt::SoaFetch{tab, nullptr, tab.miss}, en,
                                     o, d, d_inv, tmin, tm, false)) {
      occ[i] = 1;  // first hit ends the lane's whole sweep
      return;
    }
  }
}

// One mesh's tree, object-space rays (K11a, K11b): the function of
// raytpu/ops/traverse_pallas.py::_closest_kernel (:115, wrapper
// pallas_closest :348) and ::_anyhit_kernel (:217, wrapper pallas_anyhit
// :414). The TPU walks a packet of 1024 lanes with one scalar node pointer,
// descending (or testing a leaf) where any lane's box hits (:158-159,
// :186-191); here the packet is the warp, 32 consecutive lanes, with
// walk.cuh's consensus walk (kWarp = true: __any_sync over every lane's box,
// leaves included) in build order (node + 1 on a hit, bvh_miss otherwise).
// Per lane the hits are those of the lane's own walk (walk.cuh:20-27). No
// transform and no merge: the caller (raytpu_torch/ops/trace.py, the
// per-(instance, mesh) loop) moves the rays to object space and merges.
// n is whole warps; a warp whose lanes are all dead writes misses and
// returns, as the TPU's dead packet starts at the end node.
//
// Outputs, each (n,) at plane stride out_s in `out`: t (BIG_T on a miss),
// u, v and the object normal (0, 0, 1 on a miss); and the mesh-local slot
// (-1 on a miss) in `slot`. The normal is K11a's, interpolated from the
// slot-ordered corner normals as w*N0 + u*N1 + v*N2, w = 1 - u - v
// (:171-179).
constexpr float BIG_T = 3.0e38f;  // "no hit" (raytpu_torch/ops/intersect.py)

__global__ void mesh_closest_kernel(const float* __restrict__ rays,
                                    long long rays_s,
                                    const float* __restrict__ tmax,
                                    float* __restrict__ out, long long out_s,
                                    int* __restrict__ slot, long long n,
                                    float tmin, rt::Entry en, rt::Tables tab,
                                    const float* __restrict__ n_soa,
                                    long long n_tris) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // n is whole warps: this leaves whole warps
  float bt = tmax[i];
  int bs = -1;
  float bu = 0.f, bv = 0.f, no[3] = {0.f, 0.f, 1.f};
  if (__any_sync(rt::kFullWarp, bt > tmin)) {
    float o[3], d[3], d_inv[3];
    rt::load_ray(rays, rays_s, i, o, d);
#pragma unroll
    for (int c = 0; c < 3; ++c) d_inv[c] = rt::safe_inverse(d[c]);
    bs = rt::closest_in_entry<true>(rt::SoaFetch{tab, nullptr, tab.miss}, en,
                                    o, d, d_inv, tmin, &bt, &bu, &bv);
    if (bs >= 0) {
      const float w = 1.0f - bu - bv;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        no[c] = w * n_soa[c * n_tris + bs] +
                bu * n_soa[(3 + c) * n_tris + bs] +
                bv * n_soa[(6 + c) * n_tris + bs];
      bs -= en.tb;  // the walk's slot is global, K11a's mesh-local
    }
  }
  out[0 * out_s + i] = bs >= 0 ? bt : BIG_T;
  out[1 * out_s + i] = bu;
  out[2 * out_s + i] = bv;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[(3 + c) * out_s + i] = no[c];
  slot[i] = bs;
}

// occ (n,) int32 out: 1 where the lane is hit within (tmin, tmax), a lane
// with tmax <= tmin is not live (0). The warp leaves once every lane is done.
__global__ void mesh_anyhit_kernel(const float* __restrict__ rays,
                                   long long rays_s,
                                   const float* __restrict__ tmax,
                                   int* __restrict__ occ, long long n,
                                   float tmin, rt::Entry en, rt::Tables tab) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // n is whole warps: this leaves whole warps
  const float tm = tmax[i];
  const bool live = tm > tmin;
  bool done = !live;
  if (__any_sync(rt::kFullWarp, live)) {
    float o[3], d[3], d_inv[3];
    rt::load_ray(rays, rays_s, i, o, d);
#pragma unroll
    for (int c = 0; c < 3; ++c) d_inv[c] = rt::safe_inverse(d[c]);
    done = rt::occluded_in_entry<true>(rt::SoaFetch{tab, nullptr, tab.miss},
                                       en, o, d, d_inv, tmin, tm, done);
  }
  occ[i] = live && done ? 1 : 0;
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

// K11a: object-space rays (6, n) f32 with a plane stride, tmax (n,) f32 ->
// out (6, n) f32 planes t, u, v, nx, ny, nz (plane stride out_s) and slot
// (n,) int32, against the one mesh whose nodes are [nb, nb + nc) of the
// concatenated tables and whose slots start at tb. n is whole warps.
int rt_mesh_closest(const void* rays, long long rays_s, const void* tmax,
                    void* out, long long out_s, void* slot, long long n,
                    float tmin, int nb, int nc, int tb, const void* bmin,
                    const void* bmax, const void* first, const void* count,
                    const void* miss, const void* v0, const void* e1,
                    const void* e2, const void* n_soa, long long n_tris,
                    void* stream) {
  if (n % 32 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    rt::Tables tab = rt::make_tables(nullptr, 0, nullptr, bmin, bmax, first,
                                     count, miss, v0, e1, e2);
    mesh_closest_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                          (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (float*)out, out_s,
        (int*)slot, n, tmin, rt::Entry{0, 0, nb, nc, tb}, tab,
        (const float*)n_soa, n_tris);
  }
  return (int)cudaGetLastError();
}

// K11b: object-space rays (6, n) f32 with a plane stride, tmax (n,) f32 ->
// occ (n,) int32, against one mesh as for rt_mesh_closest. n is whole warps.
int rt_mesh_anyhit(const void* rays, long long rays_s, const void* tmax,
                   void* occ, long long n, float tmin, int nb, int nc, int tb,
                   const void* bmin, const void* bmax, const void* first,
                   const void* count, const void* miss, const void* v0,
                   const void* e1, const void* e2, void* stream) {
  if (n % 32 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    rt::Tables tab = rt::make_tables(nullptr, 0, nullptr, bmin, bmax, first,
                                     count, miss, v0, e1, e2);
    mesh_anyhit_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                         (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (int*)occ, n, tmin,
        rt::Entry{0, 0, nb, nc, tb}, tab);
  }
  return (int)cudaGetLastError();
}

const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
