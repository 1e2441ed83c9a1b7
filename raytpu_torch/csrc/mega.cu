// Per-block ray statistics, the culling prepass of the per-lane sweeps (K7).
//
// Replaces: raytpu/ops/mega.py::_block_stats_kernel (:360, wrapper
// _block_stats :399). One CTA per block of 8 packets (block_lanes
// contiguous lanes of the wave, 8192 at K = 1024) reduces the block's live
// lanes (window > tmin) to one row of 17 f32 values:
//   o_lo[3] o_hi[3] d_lo[3] d_hi[3] t_hi neg[3] n_live
// with the TPU kernel's conventions: a block with no live lane keeps the
// +-3e38 sentinels, t_hi is at least 0 (dead lanes count as 0), neg[c]
// counts live lanes with direction component c < 0, and the counts are
// exact integers stored as f32. min/max propagate NaN as jnp.min/max do.
// Every value is a min, a max or an integer count, so the result does not
// depend on the reduction order: it equals the plain version
// (raytpu_torch/ops/mega.py::block_stats_ref) bit for bit.
//
// What bounds it on the H100: bytes. Each lane is read once (six ray planes
// and the window, 28 B), which at config4's 8.39 M lanes is 235 MB, 0.070 ms
// at 3.35 TB/s. The design: each thread strides over the block's lanes
// (neighbouring threads on neighbouring addresses), keeps its 17 partials in
// registers, then a warp-shuffle reduction and one pass over the 8 warps'
// rows in shared memory. The grid (P/8 CTAs, 1024 at config4) fills the
// 132 SMs several times over.
//
// Rays are (6, n) with rays_s elements between planes, as in traverse.cu,
// so a wave x[:, s:s+b] goes in without a copy; the window is contiguous.

#include "common.cuh"

namespace {

constexpr int STATS_W = 17;
constexpr int WARPS = rt::BLOCK / 32;
constexpr float BIG = 3e38f;

__global__ void block_stats_kernel(const float* __restrict__ rays,
                                   long long rays_s,
                                   const float* __restrict__ win,
                                   long long block_lanes, float tmin,
                                   float* __restrict__ out) {
  const long long base = (long long)blockIdx.x * block_lanes;
  float lo[6], hi[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    lo[c] = BIG;
    hi[c] = -BIG;
  }
  float t_hi = 0.0f;
  int neg[3] = {0, 0, 0};
  int live = 0;
  for (long long j = threadIdx.x; j < block_lanes; j += blockDim.x) {
    const long long i = base + j;
    const float w = win[i];
    if (!(w > tmin)) continue;
    float x[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      x[c] = rays[c * rays_s + i];
      lo[c] = rt::min_nan(lo[c], x[c]);
      hi[c] = rt::max_nan(hi[c], x[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) neg[c] += x[3 + c] < 0.0f;
    t_hi = rt::max_nan(t_hi, w);
    ++live;
  }

  // within the warp
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      lo[c] = rt::min_nan(lo[c], __shfl_down_sync(0xffffffffu, lo[c], off));
      hi[c] = rt::max_nan(hi[c], __shfl_down_sync(0xffffffffu, hi[c], off));
    }
    t_hi = rt::max_nan(t_hi, __shfl_down_sync(0xffffffffu, t_hi, off));
#pragma unroll
    for (int c = 0; c < 3; ++c)
      neg[c] += __shfl_down_sync(0xffffffffu, neg[c], off);
    live += __shfl_down_sync(0xffffffffu, live, off);
  }

  // across the warps: lane 0 of each warp writes its row, thread 0 folds
  __shared__ float rows[WARPS][STATS_W];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    float* r = rows[warp];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r[c] = lo[c];
      r[3 + c] = hi[c];
      r[6 + c] = lo[3 + c];
      r[9 + c] = hi[3 + c];
      r[13 + c] = (float)neg[c];
    }
    r[12] = t_hi;
    r[16] = (float)live;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float acc[STATS_W];
#pragma unroll
  for (int k = 0; k < STATS_W; ++k) acc[k] = rows[0][k];
  for (int w = 1; w < WARPS; ++w) {
    const float* r = rows[w];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[c] = rt::min_nan(acc[c], r[c]);
      acc[3 + c] = rt::max_nan(acc[3 + c], r[3 + c]);
      acc[6 + c] = rt::min_nan(acc[6 + c], r[6 + c]);
      acc[9 + c] = rt::max_nan(acc[9 + c], r[9 + c]);
      acc[13 + c] += r[13 + c];  // exact: counts stay below 2^24
    }
    acc[12] = rt::max_nan(acc[12], r[12]);
    acc[16] += r[16];
  }
  float* o = out + (long long)blockIdx.x * STATS_W;
#pragma unroll
  for (int k = 0; k < STATS_W; ++k) o[k] = acc[k];
}

}  // namespace

extern "C" {

// rays (6, n) f32 with a plane stride, n = n_blocks * block_lanes; window
// (n,) f32; out (n_blocks, 17) f32.
int rt_block_stats(const void* rays, long long rays_s, const void* win,
                   long long n_blocks, long long block_lanes, float tmin,
                   void* out, void* stream) {
  if (n_blocks > 0) {
    block_stats_kernel<<<(unsigned)n_blocks, rt::BLOCK, 0,
                         (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)win, block_lanes, tmin,
        (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
