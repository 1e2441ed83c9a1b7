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
// hit, bvh_miss otherwise): the TPU kernels' tie rule, the first triangle
// at the least t in build order. The plain version closest_sweep_ref /
// anyhit_sweep_ref in raytpu_torch/ops/traverse.py makes the same tests in
// the same order, so the two agree bit for bit.
//
// What bounds them on the H100. Their work is the node visits and triangle
// tests of each lane's walk (on config4's primary wave 52.7 visits and 62.4
// tests a ray for K10a; 27.6 and 38.1 a shadow ray for K10b, which stops
// at its first hit): at 67 TFLOP/s of f32 a 256-packet slice needs about
// 17 and 10 us (chip_smoke.py's bounds, operations). In practice a walk is
// a chain of dependent loads, each node's address taken from the node
// before, so a lane waits one L1/L2 round trip a step, and the lanes of a
// warp diverge as their rays take different paths; config4's tables fit in
// the 50 MB L2. Latency, not bytes or FLOPs, sets their time.
//
// What they do about it: both walk the packed 16-byte records of
// TorchScene.packed_* in build order (walk.cuh's BuildFetch), so a node
// visit is two 16-byte loads from one 32-byte sector and the 4-byte miss
// link, issued together, and a triangle test three 16-byte loads, where
// the bvh_* tables take nine scalar loads from five arrays a visit and nine
// from three a test: fewer requests a step, none waiting on another. One
// thread a lane, each lane alone, launched flat: the flat launch of the
// same records measured faster than persistent warps on whole waves (K1,
// PERF.md). K10a makes its hit record (normal, material, instance) once,
// after the walk, so it holds no registers through it. The rays, windows,
// state and flags, each read or written once, go through evict-first loads
// and stores (walk.cuh's load_once, store_once), which leave the 50 MB L2
// to the 23 MB of config4's records while a wave of 0.5 GB streams through.
// A shadow lane's flag does not depend on the order of its walk (it reaches
// the same leaves whatever the order), so K10b's order is build order as
// K10a's, and its plain version walks the same nodes.
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
                                     rt::BuildFetch f,
                                     const float* __restrict__ n_soa,
                                     long long n_tris) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bt = rt::load_once<true>(state + rt::ST_T * st_s + i);
  if (!(bt > tmin)) return;  // dead lane (window 0): never walks

  float ow[3], dw[3];
  rt::load_ray<true>(rays, rays_s, i, ow, dw);
  // the last entry that improved t, its slot and u, v
  int win_e = -1, win_s = -1;
  float win_u = 0.f, win_v = 0.f;
  for (int e = 0; e < tab.n_entries; ++e) {
    const rt::Entry en = rt::load_entry(tab, e);
    float o[3], d[3], d_inv[3];
    rt::object_ray(tab, en, ow, dw, o, d, d_inv);
    float bu = 0.f, bv = 0.f;
    const int bs = rt::closest_in_entry<false>(f, en, o, d, d_inv, tmin, &bt,
                                               &bu, &bv);
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
  rt::write_hit<true>(state, st_s, i, bt, hit);
}

__global__ void anyhit_sweep_kernel(const float* __restrict__ rays,
                                    long long rays_s,
                                    const float* __restrict__ tmax,
                                    int* __restrict__ occ, long long n,
                                    float tmin, rt::Tables tab,
                                    rt::BuildFetch f) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (rt::load_once<true>(occ + i) != 0) return;  // OR-merge: occluded
  const float tm = rt::load_once<true>(tmax + i);
  if (!(tm > tmin)) return;

  float ow[3], dw[3];
  rt::load_ray<true>(rays, rays_s, i, ow, dw);
  for (int e = 0; e < tab.n_entries; ++e) {
    const rt::Entry en = rt::load_entry(tab, e);
    float o[3], d[3], d_inv[3];
    rt::object_ray(tab, en, ow, dw, o, d, d_inv);
    if (rt::occluded_in_entry<false>(f, en, o, d, d_inv, tmin, tm, false)) {
      rt::store_once<true>(occ + i, 1);  // the first hit ends the sweep
      return;
    }
  }
}

// One mesh's tree, object-space rays (K11a, K11b): the function of
// raytpu/ops/traverse_pallas.py::_closest_kernel (:115, wrapper
// pallas_closest :348) and ::_anyhit_kernel (:217, wrapper pallas_anyhit
// :414). The TPU walks a packet of 1024 lanes with one scalar node pointer,
// descending (or testing a leaf) where any lane's box hits (:158-159,
// :186-191). No transform and no merge: the caller
// (raytpu_torch/ops/trace.py, the per-(instance, mesh) loop) moves the rays
// to object space and merges.
//
// Both keep the TPU packet's vote with the warp as the packet: 32
// consecutive lanes walk one node pointer in build order, every lane tests
// every node's box, leaves included, and the warp descends (or tests the
// leaf's triangles for every lane) where any lane's box hits (walk.cuh's
// consensus walk, kWarp = true). Per lane the hits are those of the lane's
// own walk (walk.cuh:20-28). n is whole warps; a warp whose lanes are all
// dead writes misses (K11a) and returns, as the TPU's dead packet starts at
// the end node.
//
// What bounds K11a and K11b on the H100 is what bounds K10a and K10b
// (above): dependent loads, one a node visit. The vote makes every lane
// walk the union of its warp's paths (80.6 node visits a ray on config4's
// primary wave, against 52.7 alone), but all 32 lanes load the same node
// and leaf, one request for the warp, and none waits for another's path.
// What they do about it: they walk the packed records in
// build order (BuildFetch), two 16-byte node words and the miss link a
// visit, issued together, three 16-byte words a triangle, where the bvh_*
// tables took nine scalar loads from five arrays; their rays, windows and
// outputs go evict-first, as K10a's. On config4's whole primary wave each
// lane walking alone over the same records, and the vote at inner nodes
// only, were slower for K11a and no faster than the call's spread for K11b
// (a shadow warp waits for its last lane either way), so both keep the
// vote (PERF.md, Findings).
//
// K11a's outputs, each (n,) at plane stride out_s in `out`: t (BIG_T on a
// miss), u, v and the object normal (0, 0, 1 on a miss); and the
// mesh-local slot (-1 on a miss) in `slot`. The normal is K11a's,
// interpolated from the slot-ordered corner normals as w*N0 + u*N1 + v*N2,
// w = 1 - u - v (:171-179).
constexpr float BIG_T = 3.0e38f;  // "no hit" (raytpu_torch/ops/intersect.py)

__global__ void mesh_closest_kernel(const float* __restrict__ rays,
                                    long long rays_s,
                                    const float* __restrict__ tmax,
                                    float* __restrict__ out, long long out_s,
                                    int* __restrict__ slot, long long n,
                                    float tmin, rt::Entry en,
                                    rt::BuildFetch f,
                                    const float* __restrict__ n_soa,
                                    long long n_tris) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // n is whole warps: this leaves whole warps
  float bt = rt::load_once<true>(tmax + i);
  int bs = -1;
  float bu = 0.f, bv = 0.f, no[3] = {0.f, 0.f, 1.f};
  if (__any_sync(rt::kFullWarp, bt > tmin)) {
    float o[3], d[3], d_inv[3];
    rt::load_ray<true>(rays, rays_s, i, o, d);
#pragma unroll
    for (int c = 0; c < 3; ++c) d_inv[c] = rt::safe_inverse(d[c]);
    bs = rt::closest_in_entry<true>(f, en, o, d, d_inv, tmin, &bt, &bu, &bv);
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
  rt::store_once<true>(out + i, bs >= 0 ? bt : BIG_T);
  rt::store_once<true>(out + out_s + i, bu);
  rt::store_once<true>(out + 2 * out_s + i, bv);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rt::store_once<true>(out + (3 + c) * out_s + i, no[c]);
  }
  rt::store_once<true>(slot + i, bs);
}

// occ (n,) int32 out: 1 where the lane is hit within (tmin, tmax), a lane
// with tmax <= tmin is not live (0). The warp leaves once every lane is done.
__global__ void mesh_anyhit_kernel(const float* __restrict__ rays,
                                   long long rays_s,
                                   const float* __restrict__ tmax,
                                   int* __restrict__ occ, long long n,
                                   float tmin, rt::Entry en,
                                   rt::BuildFetch f) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // n is whole warps: this leaves whole warps
  const float tm = rt::load_once<true>(tmax + i);
  const bool live = tm > tmin;
  bool done = !live;
  if (__any_sync(rt::kFullWarp, live)) {
    float o[3], d[3], d_inv[3];
    rt::load_ray<true>(rays, rays_s, i, o, d);
#pragma unroll
    for (int c = 0; c < 3; ++c) d_inv[c] = rt::safe_inverse(d[c]);
    done = rt::occluded_in_entry<true>(f, en, o, d, d_inv, tmin, tm, done);
  }
  rt::store_once<true>(occ + i, live && done ? 1 : 0);
}

}  // namespace

extern "C" {

// rays (6, n) f32 and state (9, n) f32, updated in place, with plane
// strides; the entries in walk order and w2o; the packed nodes (M, 8) and
// triangles (T, 12) f32, 16-byte aligned, and bvh_miss (M,) int32; the
// slot-ordered normals (9, T).
int rt_closest_sweep(const void* rays, long long rays_s, void* state,
                     long long st_s, long long n, float tmin,
                     const void* entries, int n_entries, const void* w2o,
                     const void* nodes, const void* miss, const void* tris,
                     const void* n_soa, long long n_tris, void* stream) {
  if (n > 0) {
    const rt::Tables tab = rt::make_tables(entries, n_entries, w2o);
    const rt::BuildFetch f{(const float4*)nodes, (const int*)miss,
                           (const float4*)tris};
    closest_sweep_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                           (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (float*)state, st_s, n, tmin, tab, f,
        (const float*)n_soa, n_tris);
  }
  return (int)cudaGetLastError();
}

// rays (6, n) f32 with a plane stride; tmax (n,) f32; occ (n,) int32
// OR-merged in place; the entries, w2o and the walk's tables as for
// rt_closest_sweep.
int rt_anyhit_sweep(const void* rays, long long rays_s, const void* tmax,
                    void* occ, long long n, float tmin, const void* entries,
                    int n_entries, const void* w2o, const void* nodes,
                    const void* miss, const void* tris, void* stream) {
  if (n > 0) {
    const rt::Tables tab = rt::make_tables(entries, n_entries, w2o);
    const rt::BuildFetch f{(const float4*)nodes, (const int*)miss,
                           (const float4*)tris};
    anyhit_sweep_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                          (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (int*)occ, n, tmin,
        tab, f);
  }
  return (int)cudaGetLastError();
}

// K11a: object-space rays (6, n) f32 with a plane stride, tmax (n,) f32 ->
// out (6, n) f32 planes t, u, v, nx, ny, nz (plane stride out_s) and slot
// (n,) int32, against the one mesh whose nodes are [nb, nb + nc) of the
// concatenated tables and whose slots start at tb; its packed nodes and
// triangles and bvh_miss as for rt_closest_sweep. n is whole warps.
int rt_mesh_closest(const void* rays, long long rays_s, const void* tmax,
                    void* out, long long out_s, void* slot, long long n,
                    float tmin, int nb, int nc, int tb, const void* nodes,
                    const void* miss, const void* tris, const void* n_soa,
                    long long n_tris, void* stream) {
  if (n % 32 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const rt::BuildFetch f{(const float4*)nodes, (const int*)miss,
                           (const float4*)tris};
    mesh_closest_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                          (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (float*)out, out_s,
        (int*)slot, n, tmin, rt::Entry{0, 0, nb, nc, tb}, f,
        (const float*)n_soa, n_tris);
  }
  return (int)cudaGetLastError();
}

// K11b: object-space rays (6, n) f32 with a plane stride, tmax (n,) f32 ->
// occ (n,) int32, against the one mesh [nb, nb + nc), tb; its packed nodes
// and triangles and bvh_miss as for rt_closest_sweep. n is whole warps.
int rt_mesh_anyhit(const void* rays, long long rays_s, const void* tmax,
                   void* occ, long long n, float tmin, int nb, int nc, int tb,
                   const void* nodes, const void* miss, const void* tris,
                   void* stream) {
  if (n % 32 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const rt::BuildFetch f{(const float4*)nodes, (const int*)miss,
                           (const float4*)tris};
    mesh_anyhit_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                         (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (int*)occ, n, tmin,
        rt::Entry{0, 0, nb, nc, tb}, f);
  }
  return (int)cudaGetLastError();
}

// The registers and local bytes a thread (spills and local arrays) of K10a
// (which 0), K10b (1), K11a (2) or K11b (3), the CTAs of rt::BLOCK threads
// resident per SM and the SMs, into out[0..3].
int rt_traverse_attributes(int which, int* out) {
  const void* const kernels[] = {
      (const void*)closest_sweep_kernel, (const void*)anyhit_sweep_kernel,
      (const void*)mesh_closest_kernel, (const void*)mesh_anyhit_kernel};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  return rt::kernel_attributes(kernels[which], out);
}

const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
