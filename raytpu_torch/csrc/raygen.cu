// Jittered primary rays, written straight into the packed (6, P, K) buffer.
//
// Replaces: raytpu/ops/raygen.py::_raygen_kernel (:70, wrapper raygen_packed
// :133). One thread per lane applies exactly the operations of
// raygen.py:84-110, in that order: the shader-hash jitter
// fract(sin(px*12.9898 + py*78.233 + 1113.1*seed) * 43758.5453), the NDC
// y-flip, focal length 2.5, a normalize, and the camera position as origin.
//
// Precision: the sin argument reaches about 1e5 on a 1080p frame, where the
// fast intrinsic __sinf is wrong, so the library is built without
// --use_fast_math and calls the precise sinf. The hash is chaotic in the
// last bit of its argument, so the kernel is held to the raygen contract of
// tests/test_raygen.py (origins exact, unit directions, directions within
// 2.5/H), not to bitwise equality with another implementation.
//
// What bounds it on the H100: bytes. Two f32 coordinate planes in, six out
// (32 bytes per lane); the arithmetic is a few dozen flops.
//
// What this first version does about it: nothing yet. Right and simple
// first: one thread per lane, plain coalesced loads and stores.

#include "common.cuh"

namespace {

constexpr float FOCAL_LENGTH = 2.5f;

__device__ __forceinline__ float hash_rnd(float px, float py, float seed) {
  float x = sinf(px * 12.9898f + py * 78.233f + 1113.1f * seed) * 43758.5453f;
  return x - floorf(x);
}

// cam: (13,) = position, right, up, forward (4 x 3) then spp.
__global__ void raygen_kernel(const float* __restrict__ cam,
                              const float* __restrict__ s_row,
                              const float* __restrict__ px_in,
                              const float* __restrict__ py_in,
                              float* __restrict__ rays, long long n, int k,
                              int width, int height) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = px_in[i];
  const float py = py_in[i];
  const float s = s_row[i / k];
  const float seed0 = cam[12] + s;  // seedOffset = samples (shader.rgen:69)

  const float ux = ((px + hash_rnd(px, py, seed0)) / (float)width) * 2.0f - 1.0f;
  const float uy =
      -(((py + hash_rnd(px, py, seed0 + 0.5f)) / (float)height) * 2.0f - 1.0f);
  float d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    d[c] = ux * cam[3 + c] + uy * cam[6 + c] + FOCAL_LENGTH * cam[9 + c];
  // ops/vec3.normalize, op for op
  const float inv =
      1.0f / rt::max_nan(sqrtf(rt::max_nan(d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                                           0.0f)),
                         1e-30f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rays[c * n + i] = cam[c];
    rays[(3 + c) * n + i] = d[c] * inv;
  }
}

}  // namespace

extern "C" {

// cam (13,) f32; s_row (P,) f32; px, py (P*K,) f32; rays (6, P*K) f32 out.
int rt_raygen(const void* cam, const void* s_row, const void* px,
              const void* py, void* rays, long long n, int k, int width,
              int height, void* stream) {
  if (n > 0) {
    raygen_kernel<<<rt::grid_for(n), rt::BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)cam, (const float*)s_row, (const float*)px,
        (const float*)py, (float*)rays, n, k, width, height);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
