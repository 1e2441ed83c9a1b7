// One ray's walk of one entry's tree, shared by the chained sweeps
// (traverse.cu, K10a/K10b) and the per-lane sweeps (perlane.cu, K1/K2).
//
// The walk is stackless: from the root, a leaf's triangles are tested on
// arrival, with no box test at the leaf (raytpu/ops/traverse.py:117-127),
// and an inner node descends when rt::slab hits within (tmin, best_t). What
// differs between the tiers is only where the walk goes next:
//   - build order (K10a/K10b): a hit continues at node + 1, a miss or a
//     finished leaf at bvh_miss;
//   - near child first (K1/K2): the per-octant succ/skip links of
//     raytpu/ops/mega.py:128 (octant_links), one (M,) row per octant.
// Both are given as `succ` (nullptr for node + 1) and `skip`, indexed by the
// node's row g = node_base + node in the concatenated tables. Node ids in
// every link table are mesh-local, like bvh_miss.
//
// The plain versions (raytpu_torch/ops/traverse.py::_walk, closest_ref,
// anyhit_ref) make the same tests in the same order.
#pragma once

#include "common.cuh"

namespace rt {

struct Tables {
  const int* entries;  // (E, 5) int32 rows, in walk order
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

inline Tables make_tables(const void* entries, int n_entries, const void* w2o,
                          const void* bmin, const void* bmax,
                          const void* first, const void* count,
                          const void* miss, const void* v0, const void* e1,
                          const void* e2) {
  return Tables{(const int*)entries, n_entries,       (const float*)w2o,
                (const float*)bmin,  (const float*)bmax, (const int*)first,
                (const int*)count,   (const int*)miss,   (const float*)v0,
                (const float*)e1,    (const float*)e2};
}

struct Entry {
  int inst, mat, nb, nc, tb;  // instance, material, node base/count, tri base
};

__device__ __forceinline__ Entry load_entry(const Tables& tab, int e) {
  const int* r = tab.entries + ENTRY_COLS * e;
  return Entry{r[0], r[1], r[2], r[3], r[4]};
}

// world ray -> the entry instance's object space, with safe 1/d
__device__ __forceinline__ const float* object_ray(const Tables& tab,
                                                   const Entry& en,
                                                   const float* ow,
                                                   const float* dw, float* o,
                                                   float* d, float* d_inv) {
  const float* m = tab.w2o + 12 * en.inst;
  to_object(m, ow, dw, o, d);
#pragma unroll
  for (int c = 0; c < 3; ++c) d_inv[c] = safe_inverse(d[c]);
  return m;
}

// Closest hit in one entry: lowers *bt on each strict improvement and
// returns the winning BVH slot (-1 if none), with its u, v.
__device__ __forceinline__ int closest_in_entry(
    const Tables& tab, const Entry& en, const int* succ, const int* skip,
    const float* o, const float* d, const float* d_inv, float tmin, float* bt,
    float* bu, float* bv) {
  int bs = -1;
  int node = 0;
  while (node != en.nc) {
    const int g = en.nb + node;
    const int f = tab.first[g];
    if (f >= 0) {
      const int cnt = tab.count[g];
      for (int k = 0; k < cnt; ++k) {
        const long long s = (long long)en.tb + f + k;
        float t, u, v;
        if (moller_trumbore(o, d, tab.v0 + 3 * s, tab.e1 + 3 * s,
                            tab.e2 + 3 * s, tmin, *bt, &t, &u, &v)) {
          *bt = t;
          bs = (int)s;
          *bu = u;
          *bv = v;
        }
      }
      node = skip[g];
    } else if (slab(o, d_inv, tab.bmin + 3 * g, tab.bmax + 3 * g, tmin, *bt)) {
      node = succ ? succ[g] : node + 1;
    } else {
      node = skip[g];
    }
  }
  return bs;
}

// Any hit in one entry within (tmin, tm).
__device__ __forceinline__ bool occluded_in_entry(
    const Tables& tab, const Entry& en, const int* succ, const int* skip,
    const float* o, const float* d, const float* d_inv, float tmin, float tm) {
  int node = 0;
  while (node != en.nc) {
    const int g = en.nb + node;
    const int f = tab.first[g];
    if (f >= 0) {
      const int cnt = tab.count[g];
      for (int k = 0; k < cnt; ++k) {
        const long long s = (long long)en.tb + f + k;
        float t, u, v;
        if (moller_trumbore(o, d, tab.v0 + 3 * s, tab.e1 + 3 * s,
                            tab.e2 + 3 * s, tmin, tm, &t, &u, &v))
          return true;
      }
      node = skip[g];
    } else if (slab(o, d_inv, tab.bmin + 3 * g, tab.bmax + 3 * g, tmin, tm)) {
      node = succ ? succ[g] : node + 1;
    } else {
      node = skip[g];
    }
  }
  return false;
}

// The hit a sweep merges into the state: the last entry that improved t.
struct Hit {
  bool improved = false;
  int mat = 0, inst = 0;
  float u = 0.f, v = 0.f, n[3] = {0.f, 0.f, 0.f};
};

// Record entry `en`'s winning slot: its object normal interpolated at
// (u, v), then x W2O linear (traverse_pallas.py:584-593, :619-621).
__device__ __forceinline__ void record_hit(Hit* hit, const Entry& en,
                                           const float* m, const float* n_soa,
                                           long long n_tris, int bs, float bu,
                                           float bv) {
  const float w = 1.0f - bu - bv;
  float no[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    no[c] = w * n_soa[c * n_tris + bs] + bu * n_soa[(3 + c) * n_tris + bs] +
            bv * n_soa[(6 + c) * n_tris + bs];
  hit->n[0] = m[0] * no[0] + m[4] * no[1] + m[8] * no[2];
  hit->n[1] = m[1] * no[0] + m[5] * no[1] + m[9] * no[2];
  hit->n[2] = m[2] * no[0] + m[6] * no[1] + m[10] * no[2];
  hit->u = bu;
  hit->v = bv;
  hit->mat = en.mat;
  hit->inst = en.inst;
  hit->improved = true;
}

// Merge an improved hit into lane i of the packed 9-plane state.
__device__ __forceinline__ void write_hit(float* state, long long st_s,
                                          long long i, float bt,
                                          const Hit& hit) {
  state[ST_T * st_s + i] = bt;
  state[ST_VALID * st_s + i] = __int_as_float(1);
  state[ST_MAT * st_s + i] = __int_as_float(hit.mat);
  state[ST_INST * st_s + i] = __int_as_float(hit.inst);
  state[ST_NX * st_s + i] = hit.n[0];
  state[ST_NY * st_s + i] = hit.n[1];
  state[ST_NZ * st_s + i] = hit.n[2];
  state[ST_U * st_s + i] = hit.u;
  state[ST_V * st_s + i] = hit.v;
}

__device__ __forceinline__ void load_ray(const float* rays, long long rays_s,
                                         long long i, float* ow, float* dw) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ow[c] = rays[c * rays_s + i];
    dw[c] = rays[(3 + c) * rays_s + i];
  }
}

}  // namespace rt
