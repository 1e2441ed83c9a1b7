// Fused shade and accumulate passes of the bounce loop, one thread per lane.
//
// Replaces: raytpu/ops/epilogue.py::_shade_kernel (K3, :86, wrapper
// shade_epilogue :192) and ::_acc_kernel (K4, :236, wrapper
// accumulate_epilogue :262). They are the whole elementwise body of one
// bounce between the sweeps (integrator.bounce_core): K3 turns the closest
// sweep's packed state into the shadow rays, the Blinn-Phong terms, the
// continuation rays and the miss flags; K4 folds the shadow sweep's result
// into the carried radiance. Every operation is K3's and K4's, in their
// order, and so are the f32 constants, rounded from their double values as
// JAX and PyTorch round a Python float. The plain versions are
// shade_epilogue_ref / accumulate_epilogue_ref in raytpu_torch/ops/epilogue.py.
//
// Layout: a multi-plane operand is (planes, lanes) with `*_s` elements
// between planes, so the loop hands over a wave x[:, s:s+b] of its
// (planes, P, K) buffers without a copy; the lanes of a plane are
// contiguous. Single-plane operands are contiguous (n,) arrays.
//
// What bounds them on the H100: bytes. K3's operands hold 64 B a lane
// (rays 24, state 36, miss 4), of which it reads 52 (the state's inst, u
// and v planes are not read), and it writes 72 B (shadow rays 24, shadow
// window 4, a/b 8, lit 4, next rays 24, next window 4, miss 4). Over the
// 8,388,608 lanes of the config4 wave that is 1.040 GB, 0.311 ms at
// 3.35 TB/s (136 B and 0.341 ms counting every operand byte). Its ~100
// flops a lane (with one powf) need about 0.013 ms at 67 TFLOP/s. K4 moves
// 40 B a lane (occ 4, a/b 8, lit 4, radiance 12 in and 12 out): 335.5 MB,
// 0.100 ms.
//
// What this first version does about it: each thread reads each input once
// and writes each output once, with neighbouring threads on neighbouring
// addresses (coalesced 4-byte accesses). No vector loads, no fusion with
// the sweeps yet.

#include "common.cuh"

namespace {

// raytpu/config.py constants as f32, rounded from the double value
constexpr float HIT_EPSILON = (float)1e-2;
constexpr float IOR = (float)1.52;
constexpr float INV_IOR = (float)(1.0 / 1.52);
constexpr float RAY_TMAX = (float)1e4;
constexpr float SPEC_EXP = (float)100.0;
constexpr float TINY = (float)1e-30;  // the normalisations' floor
constexpr float KD0 = (float)0.2, KD1 = (float)1.0, KD2 = (float)0.2;
constexpr float KS0 = (float)0.8, KS1 = (float)0.8, KS2 = (float)0.8;

// 1 / max(sqrt(max(x.x, 0)), 1e-30), the normalisation of K3
__device__ __forceinline__ float inv_norm(const float* x) {
  return 1.0f /
         rt::max_nan(sqrtf(rt::max_nan(x[0] * x[0] + x[1] * x[1] + x[2] * x[2],
                                       0.0f)),
                     TINY);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// nrays may be rays and miss_out may be miss (updated in place): the thread
// reads every input of its lane before it writes any output, and no other
// thread touches the lane, so neither pair is declared __restrict__.
__global__ void shade_epilogue_kernel(
    const float* rays, long long rays_s, const float* __restrict__ st,
    long long st_s, const int* miss, float* __restrict__ srays,
    long long srays_s, float* __restrict__ swin, float* __restrict__ ab,
    long long ab_s, int* __restrict__ lit_out, float* nrays,
    long long nrays_s, float* __restrict__ nwin, int* miss_out, long long n,
    float lx, float ly, float lz) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // --- every input of the lane ---
  float o[3], d[3], nv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = rays[c * rays_s + i];
    d[c] = rays[(3 + c) * rays_s + i];
    nv[c] = st[(rt::ST_NX + c) * st_s + i];
  }
  const float t = st[rt::ST_T * st_s + i];
  const bool valid = __float_as_int(st[rt::ST_VALID * st_s + i]) != 0;
  const int mat = __float_as_int(st[rt::ST_MAT * st_s + i]);
  const int miss_in = miss[i];

  // post-sweep t > 0 is the pre-sweep active mask (epilogue.py:105-108)
  const bool active = t > 0.0f;
  const bool hit = valid;
  const int miss_new = miss_in | ((active && !valid) ? 1 : 0);

  const float inv_len = inv_norm(nv);
  float nrm[3], pos[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) nrm[c] = nv[c] * inv_len;
#pragma unroll
  for (int c = 0; c < 3; ++c) pos[c] = o[c] + t * d[c];
  const bool is_diffuse = hit && mat == 0;
  const bool is_mirror = hit && mat == 1;

  const float d_dot_n = dot3(d, nrm);
  const bool lit = is_diffuse && d_dot_n < 0.0f;  // backface break

  const float light[3] = {lx, ly, lz};
  float to_l[3], l[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) to_l[c] = light[c] - pos[c];
  const float dist = sqrtf(rt::max_nan(dot3(to_l, to_l), 0.0f));
  const float inv_dist = 1.0f / rt::max_nan(dist, TINY);
#pragma unroll
  for (int c = 0; c < 3; ++c) l[c] = inv_dist * to_l[c];

  // Blinn-Phong scalars; view = -d
  float h[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) h[c] = l[c] - d[c];
  const float inv_h = inv_norm(h);
#pragma unroll
  for (int c = 0; c < 3; ++c) h[c] = h[c] * inv_h;
  const float ndotl = rt::max_nan(dot3(nrm, l), 0.0f);
  const float ndoth = rt::max_nan(dot3(nrm, h), 0.0f);
  const float spec = powf(ndoth, SPEC_EXP);

  // mirror continuation
  float refl[3], o_m[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    refl[c] = d[c] - 2.0f * d_dot_n * nrm[c];
    o_m[c] = pos[c] + HIT_EPSILON * nrm[c];
  }

  // refractive continuation with Snell + TIR
  const bool outwards = d_dot_n > 0.0f;
  float n_f[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) n_f[c] = outwards ? -nrm[c] : nrm[c];
  const float ndoti_f = outwards ? -d_dot_n : d_dot_n;
  const float ratio = outwards ? IOR : INV_IOR;
  const float kk = 1.0f - ratio * ratio * (1.0f - ndoti_f * ndoti_f);
  const bool tir = kk < 0.0f;
  const float dn_f = dot3(d, n_f);
  const float coeff = ratio * ndoti_f + sqrtf(rt::max_nan(kk, 0.0f));
  float r[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) r[c] = ratio * d[c] - coeff * n_f[c];
  const float inv_r = inv_norm(r);
  float o_r[3], d_r[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float d_tir = d[c] - 2.0f * dn_f * n_f[c];
    const float o_tir = pos[c] + HIT_EPSILON * n_f[c];
    const float o_ref = pos[c] - HIT_EPSILON * n_f[c];
    o_r[c] = tir ? o_tir : o_ref;
    d_r[c] = tir ? d_tir : r[c] * inv_r;
  }
  const bool cont = is_mirror || (hit && mat == 2);

  // --- every output of the lane ---
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    srays[c * srays_s + i] = pos[c] + HIT_EPSILON * nrm[c];
    srays[(3 + c) * srays_s + i] = l[c];
    nrays[c * nrays_s + i] = cont ? (is_mirror ? o_m[c] : o_r[c]) : o[c];
    nrays[(3 + c) * nrays_s + i] =
        cont ? (is_mirror ? refl[c] : d_r[c]) : d[c];
  }
  swin[i] = lit ? dist : 0.0f;
  lit_out[i] = lit ? 1 : 0;
  ab[i] = ndotl;
  ab[ab_s + i] = spec;
  nwin[i] = cont ? RAY_TMAX : 0.0f;
  miss_out[i] = miss_new;
}

// radiance += decay * I * (kd * a + ks * b) where lit and not occluded;
// decay is per packet of k lanes (the spp fold keeps one sample per packet)
__global__ void accumulate_epilogue_kernel(
    const int* __restrict__ occ, const float* __restrict__ ab, long long ab_s,
    const int* __restrict__ lit, float* __restrict__ tmp, long long tmp_s,
    const float* __restrict__ decay_p, long long n, int k, float intensity) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool shade = lit[i] != 0 && occ[i] == 0;
  const float a = ab[i];
  const float b = ab[ab_s + i];
  const float decay = decay_p[i / k];
  const float kd[3] = {KD0, KD1, KD2};
  const float ks[3] = {KS0, KS1, KS2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float phong = intensity * (kd[c] * a + ks[c] * b);
    tmp[c * tmp_s + i] = tmp[c * tmp_s + i] + (shade ? decay * phong : 0.0f);
  }
}

}  // namespace

extern "C" {

// rays (6, n) and state (9, n) with plane strides; miss (n,) int32.
// Outputs: srays (6, n), swin (n,), ab (2, n), lit (n,) int32, nrays (6, n),
// nwin (n,), miss_out (n,) int32. nrays may be rays, miss_out may be miss.
int rt_shade_epilogue(const void* rays, long long rays_s, const void* state,
                      long long st_s, const void* miss, void* srays,
                      long long srays_s, void* swin, void* ab, long long ab_s,
                      void* lit, void* nrays, long long nrays_s, void* nwin,
                      void* miss_out, long long n, float lx, float ly, float lz,
                      void* stream) {
  if (n > 0) {
    shade_epilogue_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                            (cudaStream_t)stream>>>(
        (const float*)rays, rays_s, (const float*)state, st_s,
        (const int*)miss, (float*)srays, srays_s, (float*)swin, (float*)ab,
        ab_s, (int*)lit, (float*)nrays, nrays_s, (float*)nwin,
        (int*)miss_out, n, lx, ly, lz);
  }
  return (int)cudaGetLastError();
}

// occ (n,) int32; ab (2, n) with plane stride; lit (n,) int32; tmp (3, n)
// with plane stride, updated in place; decay_p (n / k,) f32.
int rt_accumulate_epilogue(const void* occ, const void* ab, long long ab_s,
                           const void* lit, void* tmp, long long tmp_s,
                           const void* decay_p, long long n, int k,
                           float intensity, void* stream) {
  if (n > 0) {
    accumulate_epilogue_kernel<<<rt::grid_for(n), rt::BLOCK, 0,
                                 (cudaStream_t)stream>>>(
        (const int*)occ, (const float*)ab, ab_s, (const int*)lit,
        (float*)tmp, tmp_s, (const float*)decay_p, n, k, intensity);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
