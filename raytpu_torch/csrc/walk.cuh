// One ray's walk of one entry's tree, shared by the chained sweeps and the
// one-mesh walks (traverse.cu, K10a/K10b, K11a/K11b) and the consensus
// sweeps (consensus.cu, K8/K9), and the helpers every sweep shares (the
// entries, the schedule, the triangle test, the hit record). The per-lane
// sweeps (perlane.cu, K1/K2) walk the child-pair records with a stack of
// their own and share only the helpers.
//
// The walk is stackless: from the root, an inner node descends when rt::slab
// hits within (tmin, best_t), and a leaf's triangles are tested. Where the
// walk goes next is a successor on a box hit and a skip link otherwise,
// indexed by the node's row g = node_base + node in the concatenated tables:
//   - build order (K10a/K10b, K11a/K11b): a hit continues at node + 1, a
//     miss or a finished leaf at bvh_miss;
//   - near child first: the per-octant succ/skip links of
//     raytpu/ops/mega.py:128 (octant_links), one (M,) row per octant,
//     which K1/K2's pair walk follows in the same order (perlane.cu);
//   - wide (K8/K9): the same links with every other interior level dropped
//     (raytpu/ops/mega.py:198, widen_octant_links).
// Node ids in every link table are mesh-local, like bvh_miss.
//
// Who decides, the template argument kWarp:
//   - false, each lane alone: a leaf is tested on arrival, with no box test
//     (raytpu/ops/traverse.py:117-127), an inner node on the lane's own box;
//   - true, the consensus walk of raytpu/ops/mega.py:640 (K8/K9,
//     K11a/K11b): the 32 lanes of a warp walk one node pointer. Every lane
//     tests the box of every node, leaves included, against its own window;
//     where any lane's box hits (__any_sync), the warp descends, or tests
//     the leaf's triangles for every lane. A lane's candidates are then a
//     superset of its own walk's, and Moller-Trumbore with strict
//     t < best_t is exact per lane, so the hits are the same; only which of
//     two triangles hit at exactly the same t is kept can depend on the
//     walk. The caller keeps the warp converged: whole warps, warp-uniform
//     entries and links.
//
// How the walk reads the tree, the fetch policy F: PackedFetch reads the
// packed 16-byte records of TorchScene.packed_* with one (M,) row of
// packed {succ, skip} links, the wide links (K8/K9); BuildFetch the same
// node and triangle records in build order with bvh_miss (K10a, K10b,
// K11a, K11b). Both hand the same floats to the
// same tests as the plain walk's tables.
//
// The plain versions (raytpu_torch/ops/traverse.py::_walk, closest_ref,
// anyhit_ref, with `consensus` for kWarp) make the same tests in the same
// order.
//
// What a walk counts, the template argument kCount (default false, which
// counts nothing and compiles to the walk without it): one node visit per
// node the walk reads (the loop's step, a leaf included) and one triangle
// test per rt::moller_trumbore call, into the lane's rt::Work, which
// add_work sums over the warp into the launch's counters. A consensus walk
// counts these for its walking lanes only, and besides them the visits and
// tests the lane's own walk needs (OwnWalk). The plain walk's `counts`
// (traverse.py::_walk) counts the same numbers.
#pragma once

#include "common.cuh"

namespace rt {

// What every sweep reads besides the tree: the entries and the instances'
// transforms.
struct Tables {
  const int* entries;  // (E, 5) int32 rows, in walk order
  int n_entries;
  const float* w2o;    // (N, 12) f32 row-major 3x4 world->object
};

inline Tables make_tables(const void* entries, int n_entries,
                          const void* w2o) {
  return Tables{(const int*)entries, n_entries, (const float*)w2o};
}

struct Entry {
  int inst, mat, nb, nc, tb;  // instance, material, node base/count, tri base
};

__device__ __forceinline__ Entry load_entry(const Tables& tab, int e) {
  const int* r = tab.entries + ENTRY_COLS * e;
  return Entry{r[0], r[1], r[2], r[3], r[4]};
}

// world ray -> the entry instance's object space, with safe 1/d
__device__ __forceinline__ void object_ray(const Tables& tab, const Entry& en,
                                           const float* ow, const float* dw,
                                           float* o, float* d, float* d_inv) {
  to_object(tab.w2o + 12 * en.inst, ow, dw, o, d);
#pragma unroll
  for (int c = 0; c < 3; ++c) d_inv[c] = safe_inverse(d[c]);
}

constexpr unsigned kFullWarp = 0xffffffffu;

// A lane's node visits and triangle tests (kCount walks), and in a
// consensus walk those of them its own walk needs (OwnWalk).
struct Work {
  unsigned long long nodes = 0, tests = 0, own_nodes = 0, own_tests = 0;
};

// Sum the warp's first kN counts v[0..kN) and add them to out[0..kN),
// one 64-bit atomicAdd each from lane 0. Every lane of the warp calls it.
template <int kN>
__device__ __forceinline__ void add_counts(unsigned long long* out,
                                           unsigned long long* v) {
#pragma unroll
  for (int c = 0; c < kN; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[c] += __shfl_down_sync(kFullWarp, v[c], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < kN; ++c) atomicAdd(out + c, v[c]);
  }
}

// Sum the warp's Work and add it to out[0] (nodes), out[1] (tests) and,
// with kN = 4, out[2] (own_nodes) and out[3] (own_tests).
template <int kN = 2>
__device__ __forceinline__ void add_work(unsigned long long* out, Work w) {
  unsigned long long v[4] = {w.nodes, w.tests, w.own_nodes, w.own_tests};
  add_counts<kN>(out, v);
}

// How a walk reads the tree: a fetch policy gives, for the node of row g,
// a record (F::Node) with its first slot (-1 for an inner node), its
// triangle count, its box test and its next node; and the Moller-Trumbore
// test of slot s. The float operands reach rt::slab and
// rt::moller_trumbore in the same order whatever the policy, so every
// policy gives the same bits.

// The packed records (TorchScene.packed_*): a node is two 16-byte words
// {bmin, first} {bmax, count} of one 32-byte sector, a triangle three
// 16-byte words {v0, 0} {e1, 0} {e2, 0}. The box test of a node's words and
// the Moller-Trumbore test of slot s, shared by the packed fetch policies.
__device__ __forceinline__ bool packed_box(const float4& lo, const float4& hi,
                                           const float* o, const float* d_inv,
                                           float tmin, float tfar) {
  const float bmin[3] = {lo.x, lo.y, lo.z};
  const float bmax[3] = {hi.x, hi.y, hi.z};
  return slab(o, d_inv, bmin, bmax, tmin, tfar);
}

__device__ __forceinline__ bool packed_test(const float4* tris, long long s,
                                            const float* o, const float* d,
                                            float tmin, float best_t,
                                            float* t, float* u, float* v) {
  const float4 a = __ldg(tris + 3 * s), b = __ldg(tris + 3 * s + 1),
               c = __ldg(tris + 3 * s + 2);
  const float v0[3] = {a.x, a.y, a.z}, e1[3] = {b.x, b.y, b.z},
              e2[3] = {c.x, c.y, c.z};
  return moller_trumbore(o, d, v0, e1, e2, tmin, best_t, t, u, v);
}

// The walk over the packed records along per-octant links with every
// other interior level dropped (K8/K9, the wide links): a node's links are
// one 8-byte word {succ, skip} of the block's octant row. One visit issues its three
// loads at once, none waiting on the box test, so the next node is in a
// register before a warp's vote.
struct PackedFetch {
  const float4* nodes;  // (M, 2) float4
  const int2* links;    // (M,) int2: the lane's octant row of the links
  const float4* tris;   // (T, 3) float4

  struct Node {
    float4 lo, hi;
    int2 link;
    int first;
    __device__ __forceinline__ int count() const {
      return __float_as_int(hi.w);
    }
    __device__ __forceinline__ bool box(const float* o, const float* d_inv,
                                        float tmin, float tfar) const {
      return packed_box(lo, hi, o, d_inv, tmin, tfar);
    }
    __device__ __forceinline__ int next(int, bool down) const {
      return down ? link.x : link.y;
    }
  };

  __device__ __forceinline__ Node node(int g) const {
    const float4 lo = __ldg(nodes + 2 * g);
    return Node{lo, __ldg(nodes + 2 * g + 1), __ldg(links + g),
                __float_as_int(lo.w)};
  }
  __device__ __forceinline__ bool test(long long s, const float* o,
                                       const float* d, float tmin,
                                       float best_t, float* t, float* u,
                                       float* v) const {
    return packed_test(tris, s, o, d, tmin, best_t, t, u, v);
  }
};

// The packed records (TorchScene.packed_nodes, packed_tris) with the
// packed wide links (packed_wide), as the consensus sweeps take them.
struct Packed {
  const float4* nodes;  // (M, 2) float4 {bmin, first} {bmax, count}
  const int2* links;    // (8, M) int2 {succ, skip}
  const float4* tris;   // (T, 3) float4 {v0, 0} {e1, 0} {e2, 0}

  // the walk's fetch policy along links row `row` (the block's octant)
  __device__ __forceinline__ PackedFetch at(long long row) const {
    return PackedFetch{nodes, links + row, tris};
  }
};

// The same records walked in build order (K10a/K10b, K11a/K11b): node + 1
// on a box hit, the mesh-local bvh_miss link otherwise. The link's 4-byte
// load is issued with the node's two words, not after the box test.
struct BuildFetch {
  const float4* nodes;  // (M, 2) float4
  const int* miss;      // (M,) int32
  const float4* tris;   // (T, 3) float4

  struct Node {
    float4 lo, hi;
    int skip, first;
    __device__ __forceinline__ int count() const {
      return __float_as_int(hi.w);
    }
    __device__ __forceinline__ bool box(const float* o, const float* d_inv,
                                        float tmin, float tfar) const {
      return packed_box(lo, hi, o, d_inv, tmin, tfar);
    }
    __device__ __forceinline__ int next(int node, bool down) const {
      return down ? node + 1 : skip;
    }
  };

  __device__ __forceinline__ Node node(int g) const {
    const float4 lo = __ldg(nodes + 2 * g);
    return Node{lo, __ldg(nodes + 2 * g + 1), __ldg(miss + g),
                __float_as_int(lo.w)};
  }
  __device__ __forceinline__ bool test(long long s, const float* o,
                                       const float* d, float tmin,
                                       float best_t, float* t, float* u,
                                       float* v) const {
    return packed_test(tris, s, o, d, tmin, best_t, t, u, v);
  }
};

// Whether the walk continues below node `nd` (or tests the leaf): the
// lane's own decision, or the warp's vote on every lane's box.
template <bool kWarp, class Node>
__device__ __forceinline__ bool descend(const Node& nd, bool leaf,
                                        bool walking, const float* o,
                                        const float* d_inv, float tmin,
                                        float tfar) {
  if constexpr (kWarp) {
    return __any_sync(kFullWarp, walking && nd.box(o, d_inv, tmin, tfar));
  } else {
    return leaf || nd.box(o, d_inv, tmin, tfar);
  }
}

// The vote of a counting consensus walk (kWarp and kCount), which also
// counts what the lane's own walk needs. Alone, a lane visits a node only
// while every box of the node's ancestors in the entry hits its ray: where
// the warp descends below an inner node whose box the lane's ray misses,
// the lane's own walk takes the node's skip link, and the warp's walk
// reaches that node where it leaves the subtree, so the lane's own walk
// rejoins it there. The lane's visits count as its own while it is at the
// warp's node, its triangle tests while it is and the leaf's box hits its
// ray (a walk that tests a leaf's box needs no more).
struct OwnWalk {
  int rejoin = -1;  // where the own walk rejoins the warp's; -1: with it
  bool mine = true, hit = false;  // at the warp's node; the lane's box hit

  // descend<true>'s vote on node `node`, with the walking lane's visit
  // counted
  template <class Node>
  __device__ __forceinline__ bool vote(Work* work, const Node& nd, int node,
                                       bool leaf, bool walking,
                                       const float* o, const float* d_inv,
                                       float tmin, float tfar) {
    if (node == rejoin) rejoin = -1;
    mine = rejoin < 0;
    hit = walking && nd.box(o, d_inv, tmin, tfar);
    const bool go = __any_sync(kFullWarp, hit);
    if (walking) {
      ++work->nodes;
      work->own_nodes += mine;
    }
    if (mine && go && !leaf && !hit) rejoin = nd.next(node, false);
    return go;
  }

  // one triangle test of the warp's leaf, made by a walking lane
  __device__ __forceinline__ void test(Work* work) const {
    ++work->tests;
    work->own_tests += mine && hit;
  }
};

// Closest hit in one entry: lowers *bt on each strict improvement and
// returns the winning BVH slot (-1 if none), with its u, v. A lane whose *bt
// is not above tmin can take no hit, and does not vote. With kCount the
// walk's visits and tests go into *work.
template <bool kWarp, bool kCount = false, class F>
__device__ __forceinline__ int closest_in_entry(
    const F& f, const Entry& en, const float* o, const float* d,
    const float* d_inv, float tmin, float* bt, float* bu, float* bv,
    Work* work = nullptr) {
  constexpr bool kOwn = kWarp && kCount;
  int bs = -1;
  int node = 0;
  OwnWalk own;
  while (node != en.nc) {
    if constexpr (kCount && !kOwn) ++work->nodes;
    const auto nd = f.node(en.nb + node);
    const bool leaf = nd.first >= 0;
    const bool walking = *bt > tmin;
    bool go;
    if constexpr (kOwn)
      go = own.vote(work, nd, node, leaf, walking, o, d_inv, tmin, *bt);
    else
      go = descend<kWarp>(nd, leaf, walking, o, d_inv, tmin, *bt);
    if (leaf && go) {
      const int cnt = nd.count();
      for (int k = 0; k < cnt; ++k) {
        const long long s = (long long)en.tb + nd.first + k;
        float t, u, v;
        if constexpr (kOwn) {
          if (walking) own.test(work);
        } else if constexpr (kCount) {
          ++work->tests;
        }
        if (f.test(s, o, d, tmin, *bt, &t, &u, &v)) {
          *bt = t;
          bs = (int)s;
          *bu = u;
          *bv = v;
        }
      }
    }
    node = nd.next(node, go && !leaf);  // a finished leaf takes skip
  }
  return bs;
}

// Any hit in one entry within (tmin, tm): whether the lane is `done` after
// it (occluded, or done on entry: then it tests nothing and does not vote).
// Alone, a lane returns at its first hit; a warp returns once every lane is
// done. With kCount the walk's visits and tests go into *work.
template <bool kWarp, bool kCount = false, class F>
__device__ __forceinline__ bool occluded_in_entry(
    const F& f, const Entry& en, const float* o, const float* d,
    const float* d_inv, float tmin, float tm, bool done,
    Work* work = nullptr) {
  constexpr bool kOwn = kWarp && kCount;
  int node = 0;
  OwnWalk own;
  while (node != en.nc) {
    if constexpr (kCount && !kOwn) ++work->nodes;
    const auto nd = f.node(en.nb + node);
    const bool leaf = nd.first >= 0;
    bool go;
    if constexpr (kOwn)
      go = own.vote(work, nd, node, leaf, !done, o, d_inv, tmin, tm);
    else
      go = descend<kWarp>(nd, leaf, !done, o, d_inv, tmin, tm);
    if (leaf) {
      if (go) {
        const int cnt = nd.count();
        for (int k = 0; k < cnt && !done; ++k) {
          const long long s = (long long)en.tb + nd.first + k;
          float t, u, v;
          if constexpr (kOwn) {
            own.test(work);
          } else if constexpr (kCount) {
            ++work->tests;
          }
          done = f.test(s, o, d, tmin, tm, &t, &u, &v);
        }
      }
      if constexpr (kWarp) {
        if (__all_sync(kFullWarp, done)) return true;
      } else {
        if (done) return true;
      }
    }
    node = nd.next(node, go && !leaf);
  }
  return done;
}

// The hit a sweep merges into the state: that of the last entry that
// improved t.
struct Hit {
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
}

// A value a sweep reads or writes once (a ray plane, a window, the state,
// a flag): with kStream an evict-first load or store (__ldcs, __stcs), so
// that the wave streaming through does not push the tree's records out of
// the L2.
template <bool kStream, class T>
__device__ __forceinline__ T load_once(const T* p) {
  if constexpr (kStream) return __ldcs(p);
  else return *p;
}

template <bool kStream, class T>
__device__ __forceinline__ void store_once(T* p, T v) {
  if constexpr (kStream) __stcs(p, v);
  else *p = v;
}

// Merge an improved hit into lane i of the packed 9-plane state.
template <bool kStream = false>
__device__ __forceinline__ void write_hit(float* state, long long st_s,
                                          long long i, float bt,
                                          const Hit& hit) {
  store_once<kStream>(state + ST_T * st_s + i, bt);
  store_once<kStream>(state + ST_VALID * st_s + i, __int_as_float(1));
  store_once<kStream>(state + ST_MAT * st_s + i, __int_as_float(hit.mat));
  store_once<kStream>(state + ST_INST * st_s + i, __int_as_float(hit.inst));
  store_once<kStream>(state + ST_NX * st_s + i, hit.n[0]);
  store_once<kStream>(state + ST_NY * st_s + i, hit.n[1]);
  store_once<kStream>(state + ST_NZ * st_s + i, hit.n[2]);
  store_once<kStream>(state + ST_U * st_s + i, hit.u);
  store_once<kStream>(state + ST_V * st_s + i, hit.v);
}

template <bool kStream = false>
__device__ __forceinline__ void load_ray(const float* rays, long long rays_s,
                                         long long i, float* ow, float* dw) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ow[c] = load_once<kStream>(rays + c * rays_s + i);
    dw[c] = load_once<kStream>(rays + (3 + c) * rays_s + i);
  }
}

// The per-call schedule of the per-lane and consensus sweeps (the prepass
// of raytpu_torch/ops/mega.py): a lane skips an entry whose bit for its
// block is 0 (bits: (E, n_words) int32 words in walk order, bit b % 32 of
// word b / 32 for block b = lane / block_lanes) and walks with its BLOCK's
// octant row of the links (octs[b]; row = octs[b] * M of an (8, M) table;
// with n_nodes 1, as K1/K2 make it, the row is the octant itself).
struct Schedule {
  long long block_lanes;  // lanes per culling block
  const int* bits;        // (E, n_words) int32 bit words, walk order
  int n_words;
  const int* octs;        // (PB,) int32 block octants
  long long n_nodes;      // M
};

inline Schedule make_schedule(long long block_lanes, const void* bits,
                              int n_words, const void* octs,
                              long long n_nodes) {
  return Schedule{block_lanes, (const int*)bits, n_words, (const int*)octs,
                  n_nodes};
}

// Lane i's block word pointer, bit and links row.
struct LaneSchedule {
  const int* word;
  unsigned bit;
  long long row;

  __device__ __forceinline__ bool walks(const Schedule& sc, int e) const {
    return ((unsigned)word[(long long)e * sc.n_words] & bit) != 0;
  }
};

__device__ __forceinline__ LaneSchedule lane_schedule(const Schedule& sc,
                                                      long long i) {
  const long long b = i / sc.block_lanes;
  return LaneSchedule{sc.bits + (b >> 5), 1u << (b & 31),
                      (long long)sc.octs[b] * sc.n_nodes};
}

}  // namespace rt
