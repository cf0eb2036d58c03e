// One source chunk's sampling and ray setup.
//
// Replaces no TPU kernel: the JAX package leaves this work to XLA, which
// fuses the sampler's threefry draws and the ray setup into the few
// fusions around its Pallas kernels.  Eager PyTorch runs the same
// composition (render/sample_kernels.py::sample_rays_plain) as ~470
// elementwise launches a chunk, most of them 20 rounds of int64 threefry
// arithmetic, so the chunk loop waited on the host.  This kernel computes
// the same outputs, bit for bit, in one launch.
//
// For rays ordered (source l, face f, slot s), as K1, K2 and K3 read them,
// one thread per ray computes in registers:
//   - the draws of geometry/sampling.py::uniforms_for: threefry-2x32 (20
//     rounds) of fold_in(key, source_offset + l) over the counters
//     2*(f*spt + s) + {0, 1} split into high and low words, the two output
//     words xor-ed, then ((bits >> 9) | 0x3f800000) - 1;
//   - the barycoords (correctly rounded sqrt), the sample point, dvec, h
//     (norm3: x, y, z summed in order, correctly rounded root), hs, dirs
//     (true divisions) and the bin range test;
//   - the shading normal (face normal, or 'vn' interpolated and not
//     renormalised) and the interpolated albedo;
//   - pre_valid, the skip mask (render/core.py's rules) and t_self, 0
//     where skipped;
//   - for the fused forward, the contribution (Lambertian, or the GGX
//     eval_scalar of render/brdf.py at a roughness read by pointer) and
//     the clipped fine bin.
// Every product and sum is rounded on its own (-fmad=false) in the order
// of the eager composition; a division by a Python number there is the
// multiplication by its f32 reciprocal that PyTorch on CUDA makes of it
// (inv_spt here), a division by a tensor is a true division.
//
// What bounds it on an H100: the bytes it writes, ~61 a ray (dirs, h,
// bary, albedo, valid, o, t, fid, contrib, bin; 12 more with 'vn'
// normals), ~93 MB for a 64-source chunk of 23,762 faces, ~28 us at
// 3.35 TB/s.  Its reads (the chunk's sources, each face's vertices and
// attributes, once a source) are a small fraction.  Design: a pure map,
// one launch per chunk, no shared memory, no atomics (two launches are
// bit-identical), the variants (shading normal, contribution and BRDF)
// compiled apart as template arguments.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

enum Contrib { kNone = 0, kLambertian = 1, kGGX = 2 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry-2x32 with 20 rounds, as geometry/sampling.py::threefry2x32
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t x0, uint32_t x1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// torch.clamp(x, min=lo) on CUDA: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// render/brdf.py::eval_scalar(alpha, c), operation for operation
__device__ __forceinline__ float ggx_eval(float alpha, float c) {
  const float pi = static_cast<float>(3.141592653589793);
  // _D
  const float c2 = c * c;
  const float a2 = alpha * alpha;
  const float beck = (1.0f - c2) / clamp_min(a2 * c2, 1e-30f);
  const float root = (1.0f + beck) * c2;
  float d = 1.0f / clamp_min(((pi * a2) * root) * root, 1e-30f);
  d = (d * c < 1e-20f) ? 0.0f : d;
  d = (c > 0.0f) ? d : 0.0f;
  // _G1
  const float rg = a2 + ((1.0f - a2) * c) * c;
  const float sq = __fsqrt_rn(clamp_min(rg, 0.0f));
  float g = (1.0f / clamp_min(c + sq, 1e-30f)) * 2.0f;
  g = (c >= 1.0f || c <= -1.0f) ? 1.0f : g;
  g = (c > 0.0f) ? g : 0.0f;
  const float val = ((d * g) * g) * 0.25f;
  return (c > 0.0f && d > 0.0f) ? val : 0.0f;
}

template <bool VN, int MODE>
__global__ void __launch_bounds__(kThreads)
sample_rays_kernel(const float* __restrict__ v,
                   const long long* __restrict__ f,
                   const unsigned char* __restrict__ f_valid,
                   const float* __restrict__ vn,
                   const float* __restrict__ albedo,
                   const float* __restrict__ face_n,
                   const float* __restrict__ area,
                   const float* __restrict__ lighting,
                   const float* __restrict__ lnormal,
                   const long long* __restrict__ key,
                   const float* __restrict__ alpha_ptr, float alpha_val,
                   long long num_rays, int F, int spt,
                   long long source_offset, float h_lo, float h_hi,
                   float inv_spt, float bin_lower, float fine_res, int Bf,
                   float* __restrict__ dirs, float* __restrict__ h_out,
                   float* __restrict__ bary, float* __restrict__ alb_out,
                   unsigned char* __restrict__ valid,
                   float* __restrict__ normal_out, float* __restrict__ o_out,
                   float* __restrict__ t_out, int* __restrict__ fid_out,
                   float* __restrict__ contrib_out,
                   int* __restrict__ bin_out) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= num_rays) return;
  const int s = (int)(r % spt);
  const long long lf = r / spt;
  const int fi = (int)(lf % F);
  const int l = (int)(lf / F);

  // the draws: fold_in(key, source_offset + l), then the counters
  uint32_t k0, k1;
  threefry((uint32_t)key[0], (uint32_t)key[1], 0u,
           (uint32_t)(unsigned long long)(source_offset + l), k0, k1);
  const unsigned long long c0 = 2ull * ((unsigned long long)fi * spt + s);
  uint32_t a0, a1, b0, b1;
  threefry(k0, k1, (uint32_t)(c0 >> 32), (uint32_t)c0, a0, a1);
  threefry(k0, k1, (uint32_t)((c0 + 1) >> 32), (uint32_t)(c0 + 1), b0, b1);
  const float S = unit_float(a0 ^ a1);
  const float T = unit_float(b0 ^ b1);

  // barycoords and the sample point
  const float sqrtT = __fsqrt_rn(T);
  const float w0 = 1.0f - sqrtT;
  const float w1 = (1.0f - S) * sqrtT;
  const float w2 = S * sqrtT;
  const long long i0 = f[3 * fi], i1 = f[3 * fi + 1], i2 = f[3 * fi + 2];
  float p[3], n[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    p[k] = (w0 * v[3 * i0 + k] + w1 * v[3 * i1 + k]) + w2 * v[3 * i2 + k];

  // the ray from the source
  const float o[3] = {lighting[3 * l], lighting[3 * l + 1],
                      lighting[3 * l + 2]};
  const float dx = p[0] - o[0], dy = p[1] - o[1], dz = p[2] - o[2];
  const float h = __fsqrt_rn((dx * dx + dy * dy) + dz * dz);
  const float hs = clamp_min(h, 1e-12f);
  const float d[3] = {dx / hs, dy / hs, dz / hs};
  const bool in_range = (h >= h_lo) && (h <= h_hi);

  // shading normal and albedo
  const float fn[3] = {face_n[3 * fi], face_n[3 * fi + 1],
                       face_n[3 * fi + 2]};
#pragma unroll
  for (int k = 0; k < 3; ++k)
    n[k] = VN ? (w0 * vn[3 * i0 + k] + w1 * vn[3 * i1 + k])
                    + w2 * vn[3 * i2 + k]
              : fn[k];
  const float alb = (w0 * albedo[i0] + w1 * albedo[i1]) + w2 * albedo[i2];

  // validity and the skip mask
  const float ar = area[fi];
  const bool pre_valid = f_valid[fi] != 0 && in_range && ar > 0.0f;
  const float ln[3] = {lnormal[3 * l], lnormal[3 * l + 1],
                       lnormal[3 * l + 2]};
  const float cos2 = (ln[0] * d[0] + ln[1] * d[1]) + ln[2] * d[2];
  const float cos3m = -((n[0] * d[0] + n[1] * d[1]) + n[2] * d[2]);
  const float cos3f = -((fn[0] * d[0] + fn[1] * d[1]) + fn[2] * d[2]);
  const bool dead = (cos2 * cos3m <= 0.0f) && (cos2 * cos3f <= 0.0f)
                    && ((cos2 <= 0.0f) || (cos3m <= 0.0f));
  const bool skip = !pre_valid || dead;

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dirs[3 * r + k] = d[k];
    bary[3 * r + k] = k == 0 ? w0 : (k == 1 ? w1 : w2);
    o_out[3 * r + k] = o[k];
    if (VN) normal_out[3 * r + k] = n[k];
  }
  h_out[r] = hs;
  alb_out[r] = alb;
  valid[r] = pre_valid ? 1 : 0;
  t_out[r] = skip ? 0.0f : hs;
  fid_out[r] = fi;

  if (MODE != kNone) {
    // render/core.py::_contrib_and_bins on the rays before occlusion
    const float ff = clamp_min(cos3m * cos2, 0.0f) / (hs * hs);
    float c = ((ar * alb) * ff) * ff;
    if (MODE == kGGX) {
      const float a = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
      c = c * ggx_eval(a, cos3m);
    }
    c = (pre_valid ? c : 0.0f) * inv_spt;
    const int q = (int)floorf((2.0f * hs - bin_lower) / fine_res);
    const bool ok = q >= 0 && q < Bf;
    contrib_out[r] = ok ? c : 0.0f;
    bin_out[r] = q < 0 ? 0 : (q > Bf - 1 ? Bf - 1 : q);
  }
}

template <bool VN, int MODE>
cudaError_t launch(const float* v, const long long* f,
                   const unsigned char* f_valid, const float* vn,
                   const float* albedo, const float* face_n,
                   const float* area, const float* lighting,
                   const float* lnormal, const long long* key,
                   const float* alpha_ptr, float alpha_val,
                   long long num_rays, int F, int spt,
                   long long source_offset, float h_lo, float h_hi,
                   float inv_spt, float bin_lower, float fine_res, int Bf,
                   float* dirs, float* h, float* bary, float* alb,
                   unsigned char* valid, float* normal, float* o, float* t,
                   int* fid, float* contrib, int* bin, cudaStream_t stream) {
  const long long blocks = (num_rays + kThreads - 1) / kThreads;
  sample_rays_kernel<VN, MODE><<<(unsigned)blocks, kThreads, 0, stream>>>(
      v, f, f_valid, vn, albedo, face_n, area, lighting, lnormal, key,
      alpha_ptr, alpha_val, num_rays, F, spt, source_offset, h_lo, h_hi,
      inv_spt, bin_lower, fine_res, Bf, dirs, h, bary, alb, valid, normal, o,
      t, fid, contrib, bin);
  return cudaGetLastError();
}

}  // namespace

// vn: 'vn' shading normals (interpolated, written to normal); mode: 0 no
// contribution, 1 Lambertian, 2 GGX (alpha from alpha_ptr when not null,
// else alpha_val).
extern "C" int sample_rays_launch(
    const float* v, const long long* f, const unsigned char* f_valid,
    const float* vn, const float* albedo, const float* face_n,
    const float* area, const float* lighting, const float* lnormal,
    const long long* key, const float* alpha_ptr, float alpha_val,
    long long num_rays, int F, int spt, long long source_offset, float h_lo,
    float h_hi, float inv_spt, float bin_lower, float fine_res, int Bf,
    int vn_normals, int mode, float* dirs, float* h, float* bary, float* alb,
    unsigned char* valid, float* normal, float* o, float* t, int* fid,
    float* contrib, int* bin, void* stream) {
  if (num_rays <= 0 || F <= 0 || spt <= 0 || mode < kNone || mode > kGGX
      || (num_rays + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NST_SAMPLE_LAUNCH(VN_, MODE_)                                        \
  launch<VN_, MODE_>(v, f, f_valid, vn, albedo, face_n, area, lighting,      \
                     lnormal, key, alpha_ptr, alpha_val, num_rays, F, spt,   \
                     source_offset, h_lo, h_hi, inv_spt, bin_lower,          \
                     fine_res, Bf, dirs, h, bary, alb, valid, normal, o, t,  \
                     fid, contrib, bin, st)
  cudaError_t e;
  if (vn_normals) {
    e = mode == kNone ? NST_SAMPLE_LAUNCH(true, kNone)
        : mode == kLambertian ? NST_SAMPLE_LAUNCH(true, kLambertian)
                              : NST_SAMPLE_LAUNCH(true, kGGX);
  } else {
    e = mode == kNone ? NST_SAMPLE_LAUNCH(false, kNone)
        : mode == kLambertian ? NST_SAMPLE_LAUNCH(false, kLambertian)
                              : NST_SAMPLE_LAUNCH(false, kGGX);
  }
#undef NST_SAMPLE_LAUNCH
  return (int)e;
}
