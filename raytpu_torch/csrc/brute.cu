// Brute-force closest hit and occlusion: every ray against every triangle of
// a table, with no tree (brute_closest_kernel, brute_anyhit_kernel).
//
// Replaces no Pallas kernel: raytpu/ops/intersect.py::brute_closest (:163)
// and ::brute_anyhit (:226) are XLA, a lax.scan over blocks of 512
// triangles that tests every (ray, triangle) pair of a block at once. They
// are the JAX package's BVH-free path (traversal="brute" or
// bvh_builder="brute": each sweep is the per-(instance, mesh) loop over
// them, raytpu/ops/trace.py:286, :449) and its correctness oracle. The
// port's rule that a CUDA tensor launches a kernel or raises needs a kernel
// here, and the block scan does not fit the card: on config2's 1.9 M rays
// one (rays, 512) temporary is 3.9 GB.
//
// The function, as the plain versions brute_closest_ref / brute_anyhit_ref
// in raytpu_torch/ops/intersect.py compute it: for each ray, the hit of
// least t among the triangles with tmin < t < tmax (rt::moller_trumbore,
// the same operations in the same order), and among hits at exactly that t
// the lowest triangle index (raytpu's block argmin keeps a block's first,
// and its merge across blocks is strict). Each thread of
// brute_closest_kernel scans the triangles in index order with a strict
// t < best_t, which keeps the same one, so kernel and plain version agree
// bit for bit in t, prim, u and v; the flags of the any-hit depend on no
// order.
//
// What bounds it on the H100: operations. A ray's work is one
// Moller-Trumbore test per triangle (51 operations, comparisons included,
// as chip_smoke.py counts them), so the 196,608 live lanes of config4's
// 256x192 check wave against its 332,800 triangles are 6.5e10 tests, about
// 3.3e12 operations. The library is built with --fmad=false, so no two of
// them fuse: each is one instruction on one FP32 lane, and the card issues
// at most 132 SMs x 128 lanes x 1.98 GHz = 3.3e13 a second (the data
// sheet's 67 TFLOP/s counts an FMA as two), some 100 ms. The bytes (the
// rays, windows and outputs once, the triangle table once) are a few tens
// of MB.
//
// brute_closest_kernel: one thread a ray, the triangles staged through
// shared memory a tile of rt::BLOCK at a time (each thread loads one
// triangle's three 16-byte words), so the warp's 32 lanes read each
// triangle's words together, a broadcast from shared memory, and the table
// is read from device memory once per block of rays. A block whose rays are
// all dead skips the scan.
//
// brute_anyhit_kernel: a lane's work ends at its first hit, anywhere from
// the first triangle to the last, so rays of one block or warp end far
// apart. Occlusion does not depend on the order of the tests (a lane is
// occluded iff some triangle passes the test in (tmin, tmax)), so the
// kernel is free to scan in any order from any start and stays flag for
// flag equal to the index-order scan of brute_anyhit_ref. Warps run on
// their own, with no barrier wider than the warp: a lane owns one ray,
// first the ray of its own index in the grid; when the ray ends (its first
// hit, or every triangle tested), the lane takes the next ray from a global
// counter at the next tile boundary (one atomicAdd a warp, the indices
// handed out by the popcount of the ballot of free lanes; a dead ray,
// tmax <= tmin, is written 0 and never tested). The warp walks the
// triangles as a ring of kTile-triangle tiles (the last one partial), and a
// ray that joins at a tile starts its ring there and ends after all
// ceil(T / kTile) tiles or at its first hit; the warp leaves when the
// counter is spent and its lanes are free. It stages its tiles in its own
// double-buffered slice of shared memory, one triangle a lane, its lanes
// then reading each triangle's words as a broadcast: each lane loads its
// triangle of the next tile into registers before the tests of this one
// and stores it after them. (On the H100, chip_smoke.py --sweeps: cp.async
// staging, waited on at every tile, was slower, the more so the shorter the
// ring; each lane reading every triangle from device memory, all lanes at
// one address, 2.6x slower on the config2 slice.)
//
// A test's division (1/det, rounded, then a slow path for inputs out of
// range) compiles to branches that keep the tests of a tile from
// interleaving, so a warp first runs may_occlude on every triangle of the
// tile: the operations of rt::moller_trumbore before its division, and a
// necessary condition for a hit from them, without a branch. Only the
// tile's triangles that pass it on some lane of the warp go through
// rt::moller_trumbore itself, on every lane: the condition is close to the
// test's own u and v bounds, so few of them.
//
// The grid (ops/intersect.py's anyhit_grid): once rays are long (rings of
// 12 tiles or more), one CTA of 8 warps an SM, fewer than fit. When the
// counter is spent, warps run on with free lanes until their last ray
// ends; the fewer the warps, the more rays each takes before that and the
// shorter that tail, and two warps a scheduler hide enough latency once
// the tests interleave. Short rings take one thread a ray: there the
// latency of taking a ray outweighs the tail.
//
// Rays are (6, n) planes `rays_s` elements apart, so the per-(instance,
// mesh) loop hands its object-space rays over as they are.

#include "common.cuh"

namespace {

constexpr float BIG_T = 3.0e38f;  // "no hit" distance (ops/intersect.BIG_T)

struct Tile {
  float4 w[3][rt::BLOCK];  // {v0, 0}, {e1, 0}, {e2, 0} of rt::BLOCK triangles
};

// Stage triangles base .. base + rt::BLOCK of the packed table into `tile`
// (each thread one triangle), between two barriers.
__device__ __forceinline__ int stage(Tile& tile, const float4* __restrict__ tris,
                                     int n_tris, int base) {
  __syncthreads();  // the previous tile is consumed
  const int j = base + threadIdx.x;
  if (j < n_tris) {
#pragma unroll
    for (int w = 0; w < 3; ++w) tile.w[w][threadIdx.x] = tris[3 * j + w];
  }
  __syncthreads();
  return min(rt::BLOCK, n_tris - base);
}

// rt::moller_trumbore on triangle k of a staged tile (Tile or RingTile)
template <class T>
__device__ __forceinline__ bool test(const T& tile, int k, const float* o,
                                     const float* d, float tmin, float best_t,
                                     float* t, float* u, float* v) {
  const float4 a = tile.w[0][k], b = tile.w[1][k], c = tile.w[2][k];
  const float v0[3] = {a.x, a.y, a.z};
  const float e1[3] = {b.x, b.y, b.z};
  const float e2[3] = {c.x, c.y, c.z};
  return rt::moller_trumbore(o, d, v0, e1, e2, tmin, best_t, t, u, v);
}

__global__ void __launch_bounds__(rt::BLOCK)
    brute_closest_kernel(const float* __restrict__ rays, long long rays_s,
                         const float* __restrict__ tmax,
                         const float4* __restrict__ tris, int n_tris,
                         long long n, float tmin, float* __restrict__ out,
                         long long out_s, int* __restrict__ prim) {
  __shared__ Tile tile;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  float bt = in ? tmax[i] : 0.0f;
  const bool live = in && bt > tmin;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
  if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = rays[c * rays_s + i];
      d[c] = rays[(3 + c) * rays_s + i];
    }
  }
  int bp = -1;
  float bu = 0.f, bv = 0.f;
  if (__syncthreads_or(live)) {
    for (int base = 0; base < n_tris; base += rt::BLOCK) {
      const int m = stage(tile, tris, n_tris, base);
      if (!live) continue;
      for (int k = 0; k < m; ++k) {
        float t, u, v;
        if (test(tile, k, o, d, tmin, bt, &t, &u, &v)) {
          bt = t;
          bp = base + k;
          bu = u;
          bv = v;
        }
      }
    }
  }
  if (!in) return;
  out[i] = bp >= 0 ? bt : BIG_T;
  out[out_s + i] = bu;
  out[2 * out_s + i] = bv;
  prim[i] = bp;
}

constexpr int kTile = 32;               // triangles a tile of the ring: one a lane
constexpr int kWarps = rt::BLOCK / 32;  // warps a CTA
constexpr unsigned kAll = 0xffffffffu;
constexpr long long kMaxRays = 1LL << 30;  // ray indices and the counter stay in int

struct RingTile {
  float4 w[3][kTile];  // {v0, 0}, {e1, 0}, {e2, 0} of kTile triangles
};

// Load the lane's triangle of tile `tile` (zeros past the table's end)
// into `w`; store() puts it into a warp's slice of shared memory.
__device__ __forceinline__ void fetch(float4 (&w)[3],
                                      const float4* __restrict__ tris,
                                      int n_tris, int tile, int lane) {
  const int j = tile * kTile + lane;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    w[c] = j < n_tris ? tris[3 * j + c] : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void store(RingTile& dst, const float4 (&w)[3],
                                      int lane) {
#pragma unroll
  for (int c = 0; c < 3; ++c) dst.w[c][lane] = w[c];
}

// Whether rt::moller_trumbore may find ray (o, d) to hit triangle k of
// `tile`: a necessary condition, from the operations the test makes before
// its division (the same ones, in the same order: p, det, tv, q and the
// numerators su, sv of u and v), so a warp passes over a triangle that no
// lane can hit without the division and its branches. With r = 1/det
// rounded, the test finds u = fl(su r) and v = fl(sv r), and a hit needs
// |det| > DET_EPS, u >= 0, v >= 0 and fl(u + v) <= 1 (u <= fl(u + v) when
// v >= 0, rounding being monotone). For 1e-9 < |det| < 2^100, r is normal
// and |r| >= (1 - 2^-24) / |det|; with su', sv' for su, sv times det's sign
// (exact):
// - su' <= -|det| 2^-60 puts su r below -2^-61, a normal float, so u < 0
//   (likewise v);
// - su', sv' >= 0 and fl(su' + sv') > fl(|det| (1 + 2^-16)) put u + v above
//   1 + 2^-17 before its roundings, so fl(u + v) > 1.
// A NaN su or sv fails `> -small` and is passed over: its u or v is NaN and
// the test fails too. An |det| of 2^100 or more passes.
__device__ __forceinline__ bool may_occlude(const RingTile& tile, int k,
                                            const float* o, const float* d) {
  const float4 a = tile.w[0][k], b = tile.w[1][k], c = tile.w[2][k];
  const float px = d[1] * c.z - d[2] * c.y;
  const float py = d[2] * c.x - d[0] * c.z;
  const float pz = d[0] * c.y - d[1] * c.x;
  const float det = b.x * px + b.y * py + b.z * pz;
  const float tvx = o[0] - a.x;
  const float tvy = o[1] - a.y;
  const float tvz = o[2] - a.z;
  const float qx = tvy * b.z - tvz * b.y;
  const float qy = tvz * b.x - tvx * b.z;
  const float qz = tvx * b.y - tvy * b.x;
  float su = tvx * px + tvy * py + tvz * pz;
  float sv = d[0] * qx + d[1] * qy + d[2] * qz;
  if (det < 0.0f) {
    su = -su;
    sv = -sv;
  }
  const float ad = fabsf(det);
  const float small = ad * 0x1p-60f;
  // & and |, not && and ||: no branch, so the tests of a tile interleave
  const bool inside = (su > -small) & (sv > -small) &
                      !((su >= 0.0f) & (sv >= 0.0f) &
                        (su + sv > ad * (1.0f + 0x1p-16f)));
  return (ad > rt::DET_EPS) & (inside | !(ad < 0x1p100f));
}

// n rays; next: the int32 ray counter, zeroed before the launch.
__global__ void __launch_bounds__(rt::BLOCK)
    brute_anyhit_kernel(const float* __restrict__ rays, long long rays_s,
                        const float* __restrict__ tmax,
                        const float4* __restrict__ tris, int n_tris, int n,
                        float tmin, int* __restrict__ occ,
                        int* __restrict__ next) {
  __shared__ RingTile ring[kWarps][2];
  const int lane = threadIdx.x & 31;
  RingTile* buf = ring[threadIdx.x >> 5];
  const unsigned below = (1u << lane) - 1u;
  // an empty table is one empty tile: every ray ends unoccluded after it
  const int n_tiles = max(1, (n_tris + kTile - 1) / kTile);
  // the warps start spread over the ring (any start gives the same flags)
  int cur = (int)(((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) %
                  n_tiles);
  int ray = -1, left = 0;  // the lane's ray (-1: none), tiles its ring has left
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f}, tm = 0.f;
  // Lane i of the grid's `threads` takes ray i first, then the rays from
  // `threads` on through the counter
  const int threads = gridDim.x * rt::BLOCK;
  auto take = [&](int i) {
    if (i >= n) return;
    const float t = tmax[i];
    if (t > tmin) {
      ray = i;
      tm = t;
      left = n_tiles;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o[c] = rays[c * rays_s + i];
        d[c] = rays[(3 + c) * rays_s + i];
      }
    } else {
      occ[i] = 0;  // dead: no triangle can be hit in (tmin, tmax)
    }
  };
  take(blockIdx.x * rt::BLOCK + threadIdx.x);
  bool more = threads < n;  // the counter may still hold rays (warp-uniform)
  if (!more && __ballot_sync(kAll, ray >= 0) == 0) return;
  float4 next_tri[3];  // the lane's triangle of the next tile
  fetch(next_tri, tris, n_tris, cur, lane);
  int b = 0;
  store(buf[b], next_tri, lane);
  __syncwarp();
  for (;;) {
    // free lanes take the next rays, one atomicAdd for the warp
    for (unsigned free; more && (free = __ballot_sync(kAll, ray < 0)) != 0;) {
      const int want = __popc(free);
      int base = 0;
      if (lane == 0) base = atomicAdd(next, want);
      base = threads + __shfl_sync(kAll, base, 0);
      more = base < n - want;
      if (ray < 0) take(base + __popc(free & below));
    }
    if (__ballot_sync(kAll, ray >= 0) == 0) return;
    const int nt = cur + 1 == n_tiles ? 0 : cur + 1;
    fetch(next_tri, tris, n_tris, nt, lane);  // in flight during the tests
    const int m = min(kTile, n_tris - cur * kTile);
    unsigned cand = 0;  // the tile's triangles the lane's ray may hit
#pragma unroll 16
    for (int k = 0; k < m; ++k)
      if (may_occlude(buf[b], k, o, d)) cand |= 1u << k;
    // the warp's candidates, each tested in full on every lane
    bool hit = false;
    for (cand = __reduce_or_sync(kAll, ray >= 0 ? cand : 0u); cand;
         cand &= cand - 1) {
      float t, u, v;
      hit |= test(buf[b], __ffs(cand) - 1, o, d, tmin, tm, &t, &u, &v);
    }
    if (ray >= 0 && (hit || --left == 0)) {
      occ[ray] = hit;
      ray = -1;
    }
    store(buf[b ^ 1], next_tri, lane);
    __syncwarp();  // the next tile is in; every lane is done with this one
    b ^= 1;
    cur = nt;
  }
}

}  // namespace

extern "C" {

// rays (6, n) planes rays_s apart, tmax (n,), the packed triangles (T, 12)
// f32 and T, n, tmin; out (3, n) planes out_s apart (t, u, v) and prim (n,)
// int32.
int rt_brute_closest(const void* rays, long long rays_s, const void* tmax,
                     const void* tris, int n_tris, long long n, float tmin,
                     void* out, long long out_s, void* prim, void* stream) {
  if (n > 0) {
    brute_closest_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                           (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (const float4*)tris,
        n_tris, n, tmin, (float*)out, out_s, (int*)prim);
  }
  return (int)cudaGetLastError();
}

// The same operands; occ (n,) int32, 1 where occluded; next: one int32,
// zeroed; grid: the CTAs of the persistent launch (ops/intersect.py's
// anyhit_grid).
int rt_brute_anyhit(const void* rays, long long rays_s, const void* tmax,
                    const void* tris, int n_tris, long long n, float tmin,
                    void* occ, void* next, int grid, void* stream) {
  if (n >= kMaxRays || n_tris < 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    brute_anyhit_kernel<<<grid, rt::BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (const float4*)tris,
        n_tris, (int)n, tmin, (int*)occ, (int*)next);
  }
  return (int)cudaGetLastError();
}

// The registers and local bytes a thread of brute_closest_kernel (which 0)
// or brute_anyhit_kernel (1), the CTAs of rt::BLOCK threads resident per SM
// and the SMs, into out[0..3].
int rt_brute_attributes(int which, int* out) {
  const void* const kernels[] = {(const void*)brute_closest_kernel,
                                 (const void*)brute_anyhit_kernel};
  if (which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  return rt::kernel_attributes(kernels[which], out);
}

}  // extern "C"
