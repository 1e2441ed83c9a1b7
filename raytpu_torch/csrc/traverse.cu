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
// Leaf rule: a leaf's triangles are tested on arrival, with no box test at
// the leaf (traverse.py:117-127). The plain version closest_sweep_ref /
// anyhit_sweep_ref in raytpu_torch/ops/traverse.py uses the same rule and
// the same operation order, so the two agree bit for bit.
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

#include "common.cuh"

namespace {

struct Tables {
  const int* entries;  // (E, 5) int32
  int n_entries;
  const float* w2o;    // (N, 12) f32 row-major 3x4 world->object
  const float* bmin;   // (M, 3) f32
  const float* bmax;   // (M, 3) f32
  const int* first;    // (M,) int32, -1 for inner nodes, mesh-local slot
  const int* count;    // (M,) int32
  const int* miss;     // (M,) int32 mesh-local skip link
  const float* v0;     // (T, 3) f32 in BVH-slot order
  const float* e1;     // (T, 3)
  const float* e2;     // (T, 3)
};

__global__ void closest_sweep_kernel(const float* __restrict__ rays,
                                     long long rays_s,
                                     float* __restrict__ state,
                                     long long st_s, long long n,
                                     float tmin, Tables tab,
                                     const float* __restrict__ n_soa,
                                     long long n_tris) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bt = state[rt::ST_T * st_s + i];
  if (!(bt > tmin)) return;  // dead lane (window 0): never walks

  float ow[3], dw[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ow[c] = rays[c * rays_s + i];
    dw[c] = rays[(3 + c) * rays_s + i];
  }
  bool improved = false;
  int hit_mat = 0, hit_inst = 0;
  float hit_u = 0.f, hit_v = 0.f, hit_n[3] = {0.f, 0.f, 0.f};

  for (int e = 0; e < tab.n_entries; ++e) {
    const int* ent = tab.entries + rt::ENTRY_COLS * e;
    const int inst = ent[0], mat = ent[1], nb = ent[2], nc = ent[3],
              tb = ent[4];
    const float* m = tab.w2o + 12 * inst;
    float o[3], d[3], d_inv[3];
    rt::to_object(m, ow, dw, o, d);
#pragma unroll
    for (int c = 0; c < 3; ++c) d_inv[c] = rt::safe_inverse(d[c]);

    int bs = -1;
    float bu = 0.f, bv = 0.f;
    int node = 0;
    while (node != nc) {
      const int g = nb + node;
      const int f = tab.first[g];
      if (f >= 0) {
        const int cnt = tab.count[g];
        for (int k = 0; k < cnt; ++k) {
          const long long s = (long long)tb + f + k;
          float t, u, v;
          if (rt::moller_trumbore(o, d, tab.v0 + 3 * s, tab.e1 + 3 * s,
                                  tab.e2 + 3 * s, tmin, bt, &t, &u, &v)) {
            bt = t;
            bs = (int)s;
            bu = u;
            bv = v;
          }
        }
        node = tab.miss[g];
      } else {
        node = rt::slab(o, d_inv, tab.bmin + 3 * g, tab.bmax + 3 * g, tmin,
                        bt)
                   ? node + 1
                   : tab.miss[g];
      }
    }
    if (bs >= 0) {
      // object normal at the winning slot, then x W2O linear
      // (traverse_pallas.py:584-593, :619-621)
      const float w = 1.0f - bu - bv;
      float no[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        no[c] = w * n_soa[c * n_tris + bs] + bu * n_soa[(3 + c) * n_tris + bs] +
                bv * n_soa[(6 + c) * n_tris + bs];
      hit_n[0] = m[0] * no[0] + m[4] * no[1] + m[8] * no[2];
      hit_n[1] = m[1] * no[0] + m[5] * no[1] + m[9] * no[2];
      hit_n[2] = m[2] * no[0] + m[6] * no[1] + m[10] * no[2];
      hit_u = bu;
      hit_v = bv;
      hit_mat = mat;
      hit_inst = inst;
      improved = true;
    }
  }
  if (!improved) return;
  state[rt::ST_T * st_s + i] = bt;
  state[rt::ST_VALID * st_s + i] = __int_as_float(1);
  state[rt::ST_MAT * st_s + i] = __int_as_float(hit_mat);
  state[rt::ST_INST * st_s + i] = __int_as_float(hit_inst);
  state[rt::ST_NX * st_s + i] = hit_n[0];
  state[rt::ST_NY * st_s + i] = hit_n[1];
  state[rt::ST_NZ * st_s + i] = hit_n[2];
  state[rt::ST_U * st_s + i] = hit_u;
  state[rt::ST_V * st_s + i] = hit_v;
}

__global__ void anyhit_sweep_kernel(const float* __restrict__ rays,
                                    long long rays_s,
                                    const float* __restrict__ tmax,
                                    int* __restrict__ occ, long long n,
                                    float tmin, Tables tab) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (occ[i] != 0) return;  // OR-merge: already occluded
  const float tm = tmax[i];
  if (!(tm > tmin)) return;

  float ow[3], dw[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ow[c] = rays[c * rays_s + i];
    dw[c] = rays[(3 + c) * rays_s + i];
  }
  for (int e = 0; e < tab.n_entries; ++e) {
    const int* ent = tab.entries + rt::ENTRY_COLS * e;
    const int inst = ent[0], nb = ent[2], nc = ent[3], tb = ent[4];
    float o[3], d[3], d_inv[3];
    rt::to_object(tab.w2o + 12 * inst, ow, dw, o, d);
#pragma unroll
    for (int c = 0; c < 3; ++c) d_inv[c] = rt::safe_inverse(d[c]);
    int node = 0;
    while (node != nc) {
      const int g = nb + node;
      const int f = tab.first[g];
      if (f >= 0) {
        const int cnt = tab.count[g];
        for (int k = 0; k < cnt; ++k) {
          const long long s = (long long)tb + f + k;
          float t, u, v;
          if (rt::moller_trumbore(o, d, tab.v0 + 3 * s, tab.e1 + 3 * s,
                                  tab.e2 + 3 * s, tmin, tm, &t, &u, &v)) {
            occ[i] = 1;  // first hit ends the lane's whole sweep
            return;
          }
        }
        node = tab.miss[g];
      } else {
        node = rt::slab(o, d_inv, tab.bmin + 3 * g, tab.bmax + 3 * g, tmin,
                        tm)
                   ? node + 1
                   : tab.miss[g];
      }
    }
  }
}

Tables make_tables(const void* entries, int n_entries, const void* w2o,
                   const void* bmin, const void* bmax, const void* first,
                   const void* count, const void* miss, const void* v0,
                   const void* e1, const void* e2) {
  return Tables{(const int*)entries, n_entries,       (const float*)w2o,
                (const float*)bmin,  (const float*)bmax, (const int*)first,
                (const int*)count,   (const int*)miss,   (const float*)v0,
                (const float*)e1,    (const float*)e2};
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
    Tables tab = make_tables(entries, n_entries, w2o, bmin, bmax, first,
                             count, miss, v0, e1, e2);
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
    Tables tab = make_tables(entries, n_entries, w2o, bmin, bmax, first,
                             count, miss, v0, e1, e2);
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
