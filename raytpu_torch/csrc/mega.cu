// The culling prepass of the per-lane and consensus sweeps, in one launch
// (K7: per-block ray statistics, with the schedule made from them).
//
// Replaces: raytpu/ops/mega.py::_block_stats_kernel (:360, wrapper
// _block_stats :399), and on the card the plain ops that follow it there
// (chunk_block_hits :449, the bit packing :526-531, entry_perm :535), whose
// plain versions are raytpu_torch/ops/mega.py's block_stats_ref,
// chunk_block_hits and entry_perm.
//
// Phase A, one CTA per block of 8 packets (block_lanes contiguous lanes of
// the wave, 8192 at K = 1024), reduces the block's live lanes
// (window > tmin) to one row of 17 f32 values:
//   o_lo[3] o_hi[3] d_lo[3] d_hi[3] t_hi neg[3] n_live
// with the TPU kernel's conventions: a block with no live lane keeps the
// +-3e38 sentinels, t_hi is at least 0 (dead lanes count as 0), neg[c]
// counts live lanes with direction component c < 0, and the counts are
// exact integers stored as f32. min/max propagate NaN as jnp.min/max do.
// Every value is a min, a max or an integer count, so the result does not
// depend on the reduction order: it equals block_stats_ref bit for bit.
// The CTA's threads then take the entries in turn: each computes
// the entry's world root box from its mesh root box and the instance's
// o2w (world_root_boxes' operations, in its order), tests the block's ray
// interval against it (chunk_block_hits' f32 operations: the sign-spanning
// reciprocal, min/max over the candidates and both bounds, clamp_min(tmin),
// min with t_hi, n_live > 0) and writes the entry distance clamped at 0,
// or -1 for a miss, to enter[e, b]; thread 0 writes the block's octant
// (bit a: 2 * neg[a] > n_live).
//
// Phase B, the last CTA to arrive (each CTA fences its writes and counts
// in on `arrived`, which the C entry point zeroes on the stream; it is
// per call, so launches on separate streams share nothing), makes the
// schedule from enter[E, PB]: each entry's key ("origin": the mean entry
// distance over its hit blocks, each warp lane summing every 32nd block
// and a shuffle tree adding the lanes, a fixed order; "light": the squared
// distance from the point light to the root box); its rank in the stable
// ascending order (keys below, or equal with a lower index; NaN last, as
// torch.argsort(stable=True) puts it); then per entry, by rank, its row of
// the entry table and its ceil(PB/32) bit words (bit b % 32 of word b / 32
// for block b, from one ballot a word, padding bits 0, bit 31 the sign).
// Bits, octants and entry rows equal the plain prepass's; the mean depth
// rounds apart from PyTorch's sum (it only orders the entries).
//
// What bounds it on the H100: bytes. Each lane is read once (six ray planes
// and the window, 28 B), which at config4's 8.39 M lanes is 235 MB, 0.070 ms
// at 3.35 TB/s; the schedule adds E x PB x 4 B of enter written, read
// back once ("light") or twice ("origin"), the E x PB / 8 B of bit words,
// and E root boxes a CTA. The design: each thread
// strides over the block's lanes (neighbouring threads on neighbouring
// addresses), keeps its 17 partials in registers, then a warp-shuffle
// reduction and one pass over the 8 warps' rows in shared memory. The grid
// (P/8 CTAs, 1024 at config4) fills the 132 SMs several times over; phase B
// is one CTA's few passes over enter, a few microseconds.
//
// Rays are (6, n) with rays_s elements between planes, as in traverse.cu,
// so a wave x[:, s:s+b] goes in without a copy; the window is contiguous.

#include "common.cuh"

namespace {

constexpr int STATS_W = 17;
constexpr int WARPS = rt::BLOCK / 32;
constexpr float BIG = 3e38f;
constexpr int ORDER_ORIGIN = 0;  // ORDER_LIGHT = 1

// The schedule's operands.
struct Cull {
  long long n_blocks;     // PB
  int n_entries;          // E
  int n_words;            // ceil(PB / 32)
  int order;              // ORDER_ORIGIN or 1 ("light")
  float light[3];         // the point light ("light")
  const int* entries;     // (E, 5) int32, build order
  const float* o2w;       // (N, 3, 4) f32
  const float* node_lo;   // (M, 3) f32 bvh_aabb_min
  const float* node_hi;   // (M, 3) f32 bvh_aabb_max
  int* bits;              // out (E, n_words) int32, walk order
  int* octs;              // out (PB,) int32
  int* rows;              // out (E, 5) int32, walk order
  float* keys;            // (E,) the entries' sort keys
  int* ranks;             // (E,) their places in walk order
  float* enter;           // (E, PB) clamped entry distance, or -1: a miss
  unsigned* arrived;      // one counter, zeroed by the C entry point
};

// Entry e's mesh root box through its instance's o2w by the |linear| rule,
// op for op ops/mega.py::world_root_boxes.
__device__ void root_box(const Cull& c, int e, float lo[3], float hi[3]) {
  const int* r = c.entries + rt::ENTRY_COLS * e;
  const float* m = c.o2w + 12LL * r[0];
  const float* a = c.node_lo + 3LL * r[2];
  const float* b = c.node_hi + 3LL * r[2];
  float ce[3], he[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    ce[j] = (a[j] + b[j]) * 0.5f;
    he[j] = (b[j] - a[j]) * 0.5f;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* row = m + 4 * i;
    float cw = row[0] * ce[0] + row[1] * ce[1] + row[2] * ce[2];
    cw = cw + row[3];
    const float hw = fabsf(row[0]) * he[0] + fabsf(row[1]) * he[1] +
                     fabsf(row[2]) * he[2];
    lo[i] = cw - hw;
    hi[i] = cw + hw;
  }
}

// The block's clamped entry distance into the box (lo, hi), or -1 if its
// interval test misses it, op for op ops/mega.py::chunk_block_hits; s is
// the block's stats row, (il, ih) its interval reciprocal.
__device__ float enter_depth(const float* s, const float* il,
                             const float* ih, const float* lo,
                             const float* hi, float tmin) {
  float s_lo[3], s_hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float mn = 0.0f, mx = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float bound = k ? hi[a] : lo[a];
      const float num_lo = bound - s[3 + a];
      const float num_hi = bound - s[a];
      const float c0 = num_lo * il[a], c1 = num_lo * ih[a];
      const float c2 = num_hi * il[a], c3 = num_hi * ih[a];
      const float cmin = rt::min_nan(rt::min_nan(c0, c1), rt::min_nan(c2, c3));
      const float cmax = rt::max_nan(rt::max_nan(c0, c1), rt::max_nan(c2, c3));
      mn = k ? rt::min_nan(mn, cmin) : cmin;
      mx = k ? rt::max_nan(mx, cmax) : cmax;
    }
    s_lo[a] = mn;
    s_hi[a] = mx;
  }
  const float enter = rt::max_nan(
      rt::max_nan(rt::max_nan(s_lo[0], s_lo[1]), s_lo[2]), tmin);
  const float exit = rt::min_nan(
      rt::min_nan(rt::min_nan(s_hi[0], s_hi[1]), s_hi[2]), s[12]);
  const bool hit = enter <= exit && s[16] > 0.0f;
  return hit ? rt::max_nan(enter, 0.0f) : -1.0f;
}

// Whether key a (entry i) comes before key b (entry j) in the stable
// ascending order, NaN last.
__device__ __forceinline__ bool before(float a, int i, float b, int j) {
  const bool a_nan = a != a, b_nan = b != b;
  if (a_nan || b_nan) return !a_nan || (b_nan && i < j);
  return a < b || (a == b && i < j);
}

// Phase B: the schedule, by the last CTA.
__device__ void make_schedule(const Cull& c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const long long pb = c.n_blocks;
  if (c.order == ORDER_ORIGIN) {
    for (int e = warp; e < c.n_entries; e += WARPS) {
      const float* v = c.enter + (long long)e * pb;
      float sum = 0.0f;
      int n = 0;
      for (long long j = lane; j < pb; j += 32) {
        const float x = __ldcg(v + j);
        if (x >= 0.0f) {
          sum += x;
          ++n;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_down_sync(0xffffffffu, sum, off);
        n += __shfl_down_sync(0xffffffffu, n, off);
      }
      if (lane == 0) c.keys[e] = sum / fmaxf((float)n, 1.0f);
    }
  } else {
    for (int e = threadIdx.x; e < c.n_entries; e += blockDim.x) {
      float lo[3], hi[3], sq[3];
      root_box(c, e, lo, hi);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float x = rt::min_nan(rt::max_nan(c.light[a], lo[a]), hi[a]) -
                        c.light[a];
        sq[a] = x * x;
      }
      c.keys[e] = sq[0] + sq[1] + sq[2];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < c.n_entries; e += blockDim.x) {
    const float k = c.keys[e];
    int r = 0;
    for (int j = 0; j < c.n_entries; ++j) r += before(c.keys[j], j, k, e);
    c.ranks[e] = r;
  }
  __syncthreads();
  for (int e = warp; e < c.n_entries; e += WARPS) {
    const int r = c.ranks[e];
    if (lane < rt::ENTRY_COLS)
      c.rows[rt::ENTRY_COLS * r + lane] = c.entries[rt::ENTRY_COLS * e + lane];
    const float* v = c.enter + (long long)e * pb;
    for (int w = 0; w < c.n_words; ++w) {
      const long long j = 32LL * w + lane;
      const bool hit = j < pb && __ldcg(v + j) >= 0.0f;
      const unsigned word = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) c.bits[(long long)r * c.n_words + w] = (int)word;
    }
  }
}

__global__ void block_stats_kernel(const float* __restrict__ rays,
                                   long long rays_s,
                                   const float* __restrict__ win,
                                   long long block_lanes, float tmin,
                                   float* __restrict__ out, const Cull cull) {
  __shared__ float rows[WARPS][STATS_W];
  __shared__ float row[STATS_W];
  __shared__ bool last;
  if (blockIdx.x < cull.n_blocks) {
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
    if (threadIdx.x == 0) {
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
      for (int k = 0; k < STATS_W; ++k) {
        o[k] = acc[k];
        row[k] = acc[k];
      }
      int oct = 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) oct |= (acc[13 + c] * 2.0f > acc[16]) << c;
      cull.octs[blockIdx.x] = oct;
    }
    __syncthreads();

    // the block against each entry's world root box
    float il[3], ih[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float d_lo = row[6 + a], d_hi = row[9 + a];
      const bool spans = d_lo <= 0.0f && d_hi >= 0.0f;
      const float inv_a = spans ? -BIG : 1.0f / d_lo;
      const float inv_b = spans ? BIG : 1.0f / d_hi;
      il[a] = rt::min_nan(inv_a, inv_b);
      ih[a] = rt::max_nan(inv_a, inv_b);
    }
    for (int e = threadIdx.x; e < cull.n_entries; e += blockDim.x) {
      float blo[3], bhi[3];
      root_box(cull, e, blo, bhi);
      cull.enter[(long long)e * cull.n_blocks + blockIdx.x] =
          enter_depth(row, il, ih, blo, bhi, tmin);
    }
  }

  // count in; the last CTA makes the schedule
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(cull.arrived, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  make_schedule(cull);
}

}  // namespace

extern "C" {

// rays (6, n) f32 with a plane stride, n = n_blocks * block_lanes; window
// (n,) f32; out (n_blocks, 17) f32. The schedule of the E entries
// (build-order rows `entries` (E, 5) int32, instance transforms o2w
// (N, 3, 4) f32, node boxes (M, 3) f32) in `order` (0 "origin", 1 "light"
// from (lx, ly, lz)): bits (E, n_words) int32, octs (n_blocks,) int32 and
// rows (E, 5) int32 in walk order; keys (E,) f32, ranks (E,) int32, enter
// (E, n_blocks) f32 and one u32 `arrived` of scratch. A schedule of no
// block still orders the entries (one CTA runs phase B alone).
int rt_block_stats(const void* rays, long long rays_s, const void* win,
                   long long n_blocks, long long block_lanes, float tmin,
                   void* out, long long n_entries, int n_words, int order,
                   float lx, float ly, float lz, const void* entries,
                   const void* o2w, const void* node_lo, const void* node_hi,
                   void* bits, void* octs, void* rows, void* keys,
                   void* ranks, void* enter, void* arrived, void* stream) {
  const Cull cull{n_blocks, (int)n_entries, n_words, order, {lx, ly, lz},
                  (const int*)entries, (const float*)o2w,
                  (const float*)node_lo, (const float*)node_hi, (int*)bits,
                  (int*)octs, (int*)rows, (float*)keys, (int*)ranks,
                  (float*)enter, (unsigned*)arrived};
  const cudaError_t err = cudaMemsetAsync(arrived, 0, sizeof(unsigned),
                                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = n_blocks > 0 ? (unsigned)n_blocks : 1u;
  block_stats_kernel<<<grid, rt::BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)rays, rays_s, (const float*)win, block_lanes, tmin,
      (float*)out, cull);
  return (int)cudaGetLastError();
}

}  // extern "C"
