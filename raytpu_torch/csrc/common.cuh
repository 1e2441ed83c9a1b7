// Shared device helpers for the raytpu_torch kernels.
//
// Every helper applies the same operations, in the same order, as the plain
// PyTorch versions in raytpu_torch/ops/*.py, which in turn follow the JAX
// kernels in raytpu/ops/. The library is built with --fmad=false and without
// --use_fast_math, so each float operation rounds once, as a PyTorch eager
// op does: kernel and plain version can then agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace rt {

// packed trace-state plane order (raytpu/ops/traverse_pallas.py:466-467);
// valid, mat and inst travel as int32 bit patterns inside the f32 planes
constexpr int ST_T = 0, ST_VALID = 1, ST_MAT = 2, ST_INST = 3;
constexpr int ST_NX = 4, ST_NY = 5, ST_NZ = 6, ST_U = 7, ST_V = 8;

// entry-table row: (instance, material, node_base, node_count, tri_base)
constexpr int ENTRY_COLS = 5;

constexpr float DET_EPS = 1e-9f;
constexpr int BLOCK = 256;

// min/max that PROPAGATE NaN, like jnp.minimum/maximum and torch.minimum/
// maximum. fminf/fmaxf drop a NaN operand, which would turn the 0*inf NaN of
// a ray lying in a slab plane into a box hit that the TPU kernels skip.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : (a < b ? a : b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : (a > b ? a : b);
}

// 1/d with +-inf for zero components (raytpu/ops/intersect.py:141)
__device__ __forceinline__ float safe_inverse(float x) {
  return x != 0.0f ? 1.0f / x : (x >= 0.0f ? CUDART_INF_F : -CUDART_INF_F);
}

// world -> object from the 12 row-major w2o scalars
// (raytpu/ops/traverse_pallas.py:541-550)
__device__ __forceinline__ void to_object(const float* m, const float* ow,
                                          const float* dw, float* o,
                                          float* d) {
  o[0] = m[0] * ow[0] + m[1] * ow[1] + m[2] * ow[2] + m[3];
  o[1] = m[4] * ow[0] + m[5] * ow[1] + m[6] * ow[2] + m[7];
  o[2] = m[8] * ow[0] + m[9] * ow[1] + m[10] * ow[2] + m[11];
  d[0] = m[0] * dw[0] + m[1] * dw[1] + m[2] * dw[2];
  d[1] = m[4] * dw[0] + m[5] * dw[1] + m[6] * dw[2];
  d[2] = m[8] * dw[0] + m[9] * dw[1] + m[10] * dw[2];
}

// slab test of one node, op for op traverse_pallas._slab :70-80
__device__ __forceinline__ bool slab(const float* o, const float* d_inv,
                                     const float* bmin, const float* bmax,
                                     float tmin, float tfar_cap) {
  float tn[3], tf[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float lo = (bmin[a] - o[a]) * d_inv[a];
    float hi = (bmax[a] - o[a]) * d_inv[a];
    tn[a] = min_nan(lo, hi);
    tf[a] = max_nan(lo, hi);
  }
  float t_near = max_nan(max_nan(tn[0], tn[1]), max_nan(tn[2], tmin));
  float t_far = min_nan(min_nan(tf[0], tf[1]), min_nan(tf[2], tfar_cap));
  return t_near <= t_far;
}

// slab's test of the box {lo.xyz, hi.xyz}, with the box's entry distance
// t_near = max(slab entries, tmin) into *t_near_out (K1/K2's pair walk,
// perlane.cu), in fewer instructions: a NaN among the six slab distances (a
// 0 * inf where the ray lies in a slab plane) makes slab miss, and without
// one fminf/fmaxf give min_nan/max_nan's values (but for the sign of a
// zero, which no comparison sees), so the hits are slab's. t_near does not
// depend on tfar_cap, and t_far is the exact minimum of the slab exits and
// tfar_cap: a box that hits under one cap hits under a lower cap c exactly
// when t_near <= c.
__device__ __forceinline__ bool slab_near(const float* o, const float* d_inv,
                                          const float4& lo, const float4& hi,
                                          float tmin, float tfar_cap,
                                          float* t_near_out) {
  const float l0 = (lo.x - o[0]) * d_inv[0], h0 = (hi.x - o[0]) * d_inv[0];
  const float l1 = (lo.y - o[1]) * d_inv[1], h1 = (hi.y - o[1]) * d_inv[1];
  const float l2 = (lo.z - o[2]) * d_inv[2], h2 = (hi.z - o[2]) * d_inv[2];
  const bool nan = (l0 != l0) | (h0 != h0) | (l1 != l1) | (h1 != h1) |
                   (l2 != l2) | (h2 != h2);
  const float t_near = fmaxf(fmaxf(fminf(l0, h0), fminf(l1, h1)),
                             fmaxf(fminf(l2, h2), tmin));
  const float t_far = fminf(fminf(fmaxf(l0, h0), fmaxf(l1, h1)),
                            fminf(fmaxf(l2, h2), tfar_cap));
  *t_near_out = t_near;
  return !nan && t_near <= t_far;
}

// Moller-Trumbore, op for op traverse_pallas._mt :83-112 (strict t < best_t)
__device__ __forceinline__ bool moller_trumbore(
    const float* o, const float* d, const float* v0, const float* e1,
    const float* e2, float tmin, float best_t, float* t_out, float* u_out,
    float* v_out) {
  float px = d[1] * e2[2] - d[2] * e2[1];
  float py = d[2] * e2[0] - d[0] * e2[2];
  float pz = d[0] * e2[1] - d[1] * e2[0];
  float det = e1[0] * px + e1[1] * py + e1[2] * pz;
  bool ok = fabsf(det) > DET_EPS;
  float inv_det = ok ? 1.0f / det : 0.0f;
  float tvx = o[0] - v0[0];
  float tvy = o[1] - v0[1];
  float tvz = o[2] - v0[2];
  float u = (tvx * px + tvy * py + tvz * pz) * inv_det;
  float qx = tvy * e1[2] - tvz * e1[1];
  float qy = tvz * e1[0] - tvx * e1[2];
  float qz = tvx * e1[1] - tvy * e1[0];
  float v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det;
  float t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det;
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
         t < best_t;
}

inline int grid_for(long long n) { return (int)((n + BLOCK - 1) / BLOCK); }

// A kernel's registers and local bytes a thread (spills and local arrays,
// cudaFuncGetAttributes), the CTAs of BLOCK threads resident per SM under
// its launch bounds (the occupancy API) and the SMs, into out[0..3].
inline int kernel_attributes(const void* kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = per_sm;
  out[3] = sms;
  return (int)cudaGetLastError();
}

}  // namespace rt
