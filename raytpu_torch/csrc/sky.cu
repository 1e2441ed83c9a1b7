// Bilinear, clamp-to-edge cube-map sample from the packed RGB8 u32 map.
//
// Replaces: raytpu/ops/sky_mxu.py::_kernel (:120, with _issue_one :185 and
// _kernel_one :201; driven by _sample_mxu :398), the deferred sky fetch of
// the bounce loop. Its function is raytpu/ops/sky.py::sample_cubemap_u32
// (:113-140); the MXU window scheme exists for the TPU's matrix unit and
// does not carry over. One thread per lane ports face_st, _bilinear_coords,
// the four u32 taps, _unpack_rgb8 and the weight combine, op for op. The
// wrapper runs it on every lane, as sample_cubemap_u32 does; the integrator
// (_deferred_sky) points non-miss lanes at (0, 0, 1) and masks them.
//
// What bounds it on the H100: bytes. Three direction planes in, four
// scattered 4-byte taps, three color planes out; miss lanes of one packet
// mostly read neighbouring texels, which the L1/L2 caches catch.
//
// What this first version does about it: nothing yet. Right and simple
// first: one thread per lane, taps through the ordinary cached load path.

#include "common.cuh"

namespace {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void sky_kernel(const uint32_t* __restrict__ sky, int h, int w,
                           const float* __restrict__ dx,
                           const float* __restrict__ dy,
                           const float* __restrict__ dz,
                           float* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = dx[i], y = dy[i], z = dz[i];

  // face_st (sky.py:21-62)
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const bool is_x = (ax >= ay) && (ax >= az);
  const bool is_y = (!is_x) && (ay >= az);
  const int face = is_x ? (x >= 0.0f ? 0 : 1)
                        : (is_y ? (y >= 0.0f ? 2 : 3) : (z >= 0.0f ? 4 : 5));
  const float ma = rt::max_nan(is_x ? ax : (is_y ? ay : az), 1e-30f);
  const float sc = is_x ? (x >= 0.0f ? -z : z)
                        : (is_y ? x : (z >= 0.0f ? x : -x));
  const float tc = is_y ? (y >= 0.0f ? z : -z) : -y;
  const float s = 0.5f * (sc / ma + 1.0f);
  const float t = 0.5f * (tc / ma + 1.0f);

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
  // _unpack_rgb8: the f32 rounding of the double 1/255, as jnp.float32 does
  const float inv = (float)(1.0 / 255.0);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int sh = 8 * c;
    const float c00 = (float)((w00 >> sh) & 0xFFu) * inv;
    const float c01 = (float)((w01 >> sh) & 0xFFu) * inv;
    const float c10 = (float)((w10 >> sh) & 0xFFu) * inv;
    const float c11 = (float)((w11 >> sh) & 0xFFu) * inv;
    const float top = c00 * (1.0f - wx) + c01 * wx;
    const float bot = c10 * (1.0f - wx) + c11 * wx;
    out[c * n + i] = top * (1.0f - wy) + bot * wy;
  }
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

}  // extern "C"
