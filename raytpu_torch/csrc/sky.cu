// Cube-map samples from the packed RGB8 u32 map: bilinear, clamp-to-edge
// (sky_kernel) and single tap (sky_nearest_kernel).
//
// Replaces: raytpu/ops/sky_mxu.py::_kernel (:120, with _issue_one :185 and
// _kernel_one :201; driven by _sample_mxu :398) in its two modes, the
// deferred sky fetch of the bounce loop. bilinear=True (:453 via :555) is
// sky_kernel, whose function is raytpu/ops/sky.py::sample_cubemap_u32
// (:113-140); bilinear=False (:453 via :543,
// sample_cubemap_u32_nearest_mxu) is sky_nearest_kernel, whose function is
// raytpu/ops/sky.py::sample_cubemap_u32_nearest (:99-110), the filters
// "nearest" and "bilinear2x" (the latter on the 2x map). The MXU window
// scheme exists for the TPU's matrix unit and does not carry over. One thread
// per lane ports face_st, the tap coordinates, the u32 taps, _unpack_rgb8
// and (bilinear) the weight combine, op for op. The wrappers run them on
// every lane, as the JAX functions do; the integrator (_deferred_sky) points
// non-miss lanes at (0, 0, 1) and masks them.
//
// What bounds them on the H100: bytes. Three direction planes in, four
// scattered 4-byte taps (one for the single tap), three color planes out;
// miss lanes of one packet mostly read neighbouring texels, which the L1/L2
// caches catch.
//
// What this first version does about it: nothing yet. Right and simple
// first: one thread per lane, taps through the ordinary cached load path.

#include "common.cuh"

namespace {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// face_st (sky.py:21-62): the face and its (s, t) of one direction
__device__ __forceinline__ int face_st(float x, float y, float z, float* s,
                                       float* t) {
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const bool is_x = (ax >= ay) && (ax >= az);
  const bool is_y = (!is_x) && (ay >= az);
  const int face = is_x ? (x >= 0.0f ? 0 : 1)
                        : (is_y ? (y >= 0.0f ? 2 : 3) : (z >= 0.0f ? 4 : 5));
  const float ma = rt::max_nan(is_x ? ax : (is_y ? ay : az), 1e-30f);
  const float sc = is_x ? (x >= 0.0f ? -z : z)
                        : (is_y ? x : (z >= 0.0f ? x : -x));
  const float tc = is_y ? (y >= 0.0f ? z : -z) : -y;
  *s = 0.5f * (sc / ma + 1.0f);
  *t = 0.5f * (tc / ma + 1.0f);
  return face;
}

// _unpack_rgb8: the f32 rounding of the double 1/255, as jnp.float32 does
__device__ __forceinline__ float channel(uint32_t word, int c) {
  const float inv = (float)(1.0 / 255.0);
  return (float)((word >> (8 * c)) & 0xFFu) * inv;
}

__global__ void sky_kernel(const uint32_t* __restrict__ sky, int h, int w,
                           const float* __restrict__ dx,
                           const float* __restrict__ dy,
                           const float* __restrict__ dz,
                           float* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s, t;
  const int face = face_st(dx[i], dy[i], dz[i], &s, &t);

  // _bilinear_coords (sky.py:70-86)
  const float fx = s * (float)w - 0.5f;
  const float fy = t * (float)h - 0.5f;
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float wx = fx - x0;
  const float wy = fy - y0;
  const int x0i = (int)x0, y0i = (int)y0;
  const int x0c = clampi(x0i, 0, w - 1), x1c = clampi(x0i + 1, 0, w - 1);
  const int y0c = clampi(y0i, 0, h - 1), y1c = clampi(y0i + 1, 0, h - 1);
  const long long base = (long long)face * h * w;

  const uint32_t w00 = sky[base + (long long)y0c * w + x0c];
  const uint32_t w01 = sky[base + (long long)y0c * w + x1c];
  const uint32_t w10 = sky[base + (long long)y1c * w + x0c];
  const uint32_t w11 = sky[base + (long long)y1c * w + x1c];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float c00 = channel(w00, c), c01 = channel(w01, c);
    const float c10 = channel(w10, c), c11 = channel(w11, c);
    const float top = c00 * (1.0f - wx) + c01 * wx;
    const float bot = c10 * (1.0f - wx) + c11 * wx;
    out[c * n + i] = top * (1.0f - wy) + bot * wy;
  }
}

// sample_cubemap_u32_nearest (sky.py:99-110): floor(s*w) truncated to int,
// clamped, one tap
__global__ void sky_nearest_kernel(const uint32_t* __restrict__ sky, int h,
                                   int w, const float* __restrict__ dx,
                                   const float* __restrict__ dy,
                                   const float* __restrict__ dz,
                                   float* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s, t;
  const int face = face_st(dx[i], dy[i], dz[i], &s, &t);
  const int xc = clampi((int)floorf(s * (float)w), 0, w - 1);
  const int yc = clampi((int)floorf(t * (float)h), 0, h - 1);
  const uint32_t word = sky[(long long)face * h * w + (long long)yc * w + xc];
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c * n + i] = channel(word, c);
}

}  // namespace

extern "C" {

// sky (6*h*w,) packed RGB8 words; dx, dy, dz (n,) f32; out (3, n) f32.
int rt_sky(const void* sky, int h, int w, const void* dx, const void* dy,
           const void* dz, void* out, long long n, void* stream) {
  if (n > 0) {
    sky_kernel<<<rt::grid_for(n), rt::BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)sky, h, w, (const float*)dx, (const float*)dy,
        (const float*)dz, (float*)out, n);
  }
  return (int)cudaGetLastError();
}

// The same operands as rt_sky; one tap a lane.
int rt_sky_nearest(const void* sky, int h, int w, const void* dx,
                   const void* dy, const void* dz, void* out, long long n,
                   void* stream) {
  if (n > 0) {
    sky_nearest_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)sky, h, w, (const float*)dx, (const float*)dy,
        (const float*)dz, (float*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
