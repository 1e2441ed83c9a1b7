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
// and its merge across blocks is strict). Here each thread scans the
// triangles in index order with a strict t < best_t, which keeps the same
// one, so kernel and plain version agree bit for bit in t, prim, u and v,
// and in the flags.
//
// What bounds it on the H100: operations. A ray's work is one
// Moller-Trumbore test per triangle (51 operations, comparisons included,
// as chip_smoke.py counts them), so the 196,608 live lanes of config4's
// 256x192 check wave against its 332,800 triangles are 6.5e10 tests, about
// 3.3e12 operations, some 50 ms at 67 TFLOP/s of f32; its bytes (the rays,
// windows and outputs once, the triangle table once) are a few tens of MB.
//
// What this first version does about it: one thread a ray, the triangles
// staged through shared memory a tile of rt::BLOCK at a time (each thread
// loads one triangle's three 16-byte words), so the warp's 32 lanes read
// each triangle's words together, a broadcast from shared memory, and the
// table is read from device memory once per block of rays. A block whose
// rays are all dead skips the scan. The any-hit kernel stops a lane at its
// first hit and the whole block once every lane has stopped
// (__syncthreads_or). Rays are (6, n) planes `rays_s` elements apart, so the
// per-(instance, mesh) loop hands its object-space rays over as they are.

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

__device__ __forceinline__ bool test(const Tile& tile, int k, const float* o,
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

__global__ void __launch_bounds__(rt::BLOCK)
    brute_anyhit_kernel(const float* __restrict__ rays, long long rays_s,
                        const float* __restrict__ tmax,
                        const float4* __restrict__ tris, int n_tris,
                        long long n, float tmin, int* __restrict__ occ) {
  __shared__ Tile tile;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const float tm = in ? tmax[i] : 0.0f;
  bool pending = in && tm > tmin;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
  if (pending) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = rays[c * rays_s + i];
      d[c] = rays[(3 + c) * rays_s + i];
    }
  }
  int hit = 0;
  for (int base = 0; base < n_tris && __syncthreads_or(pending);
       base += rt::BLOCK) {
    const int m = stage(tile, tris, n_tris, base);
    if (!pending) continue;
    for (int k = 0; k < m; ++k) {
      float t, u, v;
      if (test(tile, k, o, d, tmin, tm, &t, &u, &v)) {
        hit = 1;
        pending = false;
        break;
      }
    }
  }
  if (in) occ[i] = hit;
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

// The same operands; occ (n,) int32, 1 where occluded.
int rt_brute_anyhit(const void* rays, long long rays_s, const void* tmax,
                    const void* tris, int n_tris, long long n, float tmin,
                    void* occ, void* stream) {
  if (n > 0) {
    brute_anyhit_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                          (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)tmax, (const float4*)tris,
        n_tris, n, tmin, (int*)occ);
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
