// Fused analytic backward: per-face gradient sums for one source chunk
// (kernel K2).
//
// Replaces the JAX package's Pallas TPU kernel
// nlos_surface_optimization_tpu/render/bwd_kernels.py::_bwd_kernel
// (wrapper backward_face_sums_pallas).  Per ray (ordered source, face,
// sample): the fine bin q = floor((2h - bin_lower)/fine_res) selects
// A = tabA[l,q] and Bw = tabB[l,q] (zero outside [0, Bf]); the Lambertian
// terms t1, t2 (+ gn when use_gn) give P = t1*A + dir*inten*Bw and
// S2 = t2*A; per face, summed over the slab's sources and the samples:
// P*b1, P*b2, P*b3 and S2 (12 floats).
//
// What bounds it on an H100: memory.  Each ray is read once (11 floats:
// dirs, normal, h, albw, bary) and needs two table gathers; the work per
// ray is ~80 flops.  Design: a block of 128 threads owns a tile of
// 128/spt faces and walks the sources of one 16-source slab; for each
// source the tile's rays are contiguous, so the loads coalesce; the
// table lookup is a plain gather (L1/L2; a source's two tables are
// 2*(Bf+1) floats).  Sums are deterministic: per-ray terms go to shared
// memory and one thread per (face, term) adds its face's samples in
// order; slabs are written as partial sums that the wrapper adds in slab
// order.  Compiled with -fmad=false to round as the plain version does.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;          // threads (rays) per block step
constexpr int NV = 12;           // per-face terms
constexpr int STRIDE = NT + 1;   // shared row stride (bank spread)

__global__ void __launch_bounds__(NT)
bwd_kernel(const float* __restrict__ dirs, const float* __restrict__ normal,
           const float* __restrict__ hh, const float* __restrict__ albw_in,
           const float* __restrict__ bary, const float* __restrict__ onorm,
           const float* __restrict__ inv2a_f, const float* __restrict__ tables,
           int Lc, int F, int spt, int Bf, int slab, int use_gn,
           float bin_lower, float fine_res, float* __restrict__ partial) {
  __shared__ float s_val[NV * STRIDE];
  __shared__ float s_acc[NV * NT];
  const int tid = threadIdx.x;
  const int fpb = spt < NT ? NT / spt : 1;
  const int f0 = blockIdx.x * fpb;
  const int nf = min(fpb, F - f0);
  const int n = nf * spt;
  const int l0 = blockIdx.y * slab;
  const int l1 = min(Lc, l0 + slab);
  for (int p = tid; p < nf * NV; p += NT) s_acc[p] = 0.f;

  for (int l = l0; l < l1; ++l) {
    const float ox = onorm[3 * l], oy = onorm[3 * l + 1], oz = onorm[3 * l + 2];
    const float* tabA = tables + (size_t)l * 2 * (Bf + 1);
    const float* tabB = tabA + (Bf + 1);
    const size_t base = ((size_t)l * F + f0) * spt;
    for (int c0 = 0; c0 < n; c0 += NT) {
      const int rl = c0 + tid;
      float v[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) v[k] = 0.f;
      if (rl < n) {
        const size_t r = base + rl;
        const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
        const float nx = normal[3 * r], ny = normal[3 * r + 1], nz = normal[3 * r + 2];
        const float h = hh[r];
        const float albw = albw_in[r];
        const float b1 = bary[3 * r], b2 = bary[3 * r + 1], b3 = bary[3 * r + 2];
        const float inv2a = inv2a_f[f0 + rl / spt];

        const float qf = floorf((2.f * h - bin_lower) / fine_res);
        const bool ok = fabsf(qf) < 2.0e9f && qf >= 0.f && qf <= (float)Bf;
        const int q = ok ? (int)qf : 0;
        const float A = ok ? __ldg(tabA + q) : 0.f;
        const float Bw = ok ? __ldg(tabB + q) : 0.f;

        const float cos2 = fmaxf(ox * dx + oy * dy + oz * dz, 0.f);
        const float cos3 = fmaxf(-(nx * dx + ny * dy + nz * dz), 0.f);
        const float hs = fmaxf(h, 1e-12f);
        const float inv_h2 = 1.f / (hs * hs);
        const float cc = cos2 * cos3;
        const float ff = cc * inv_h2;
        const float inten = albw * ff * ff;
        const float s1 = albw * 2.f * cc * inv_h2 * inv_h2 / hs;
        const float t1x = s1 * (ox * cos3 - nx * cos2 - 4.f * dx * cc);
        const float t1y = s1 * (oy * cos3 - ny * cos2 - 4.f * dy * cc);
        const float t1z = s1 * (oz * cos3 - nz * cos2 - 4.f * dz * cc);
        float t2x = nx * inten;
        float t2y = ny * inten;
        float t2z = nz * inten;
        if (use_gn) {
          const float sg = -2.f * albw * cos3 * cos2 * cos2 * inv_h2 * inv_h2;
          const float gx = sg * dx;
          const float gy = sg * dy;
          const float gz = sg * dz;
          const float dot = gx * nx + gy * ny + gz * nz;
          t2x = t2x + (gx - nx * dot);
          t2y = t2y + (gy - ny * dot);
          t2z = t2z + (gz - nz * dot);
        }
        t2x = t2x * inv2a;
        t2y = t2y * inv2a;
        t2z = t2z * inv2a;
        const float gsc = inten * Bw;
        const float px = t1x * A + dx * gsc;
        const float py = t1y * A + dy * gsc;
        const float pz = t1z * A + dz * gsc;
        v[0] = px * b1; v[1] = py * b1; v[2] = pz * b1;
        v[3] = px * b2; v[4] = py * b2; v[5] = pz * b2;
        v[6] = px * b3; v[7] = py * b3; v[8] = pz * b3;
        v[9] = t2x * A; v[10] = t2y * A; v[11] = t2z * A;
      }
#pragma unroll
      for (int k = 0; k < NV; ++k) s_val[k * STRIDE + tid] = v[k];
      __syncthreads();
      const int c1 = min(c0 + NT, n);
      for (int p = tid; p < nf * NV; p += NT) {
        const int k = p / nf;
        const int fl = p - k * nf;
        const int lo = max(c0, fl * spt);
        const int hi = min(c1, (fl + 1) * spt);
        if (lo < hi) {
          float sum = 0.f;
          for (int i = lo; i < hi; ++i) sum += s_val[k * STRIDE + (i - c0)];
          s_acc[p] += sum;
        }
      }
      __syncthreads();
    }
  }
  for (int p = tid; p < nf * NV; p += NT) {
    const int k = p / nf;
    const int fl = p - k * nf;
    partial[((size_t)blockIdx.y * F + f0 + fl) * NV + k] = s_acc[p];
  }
}

}  // namespace

extern "C" int backward_face_sums_launch(
    const float* dirs, const float* normal, const float* h, const float* albw,
    const float* bary, const float* onorm, const float* inv2a,
    const float* tables, int Lc, int F, int spt, int Bf, int slab,
    int use_gn, float bin_lower, float fine_res, float* partial,
    void* stream) {
  if (Lc <= 0 || F <= 0 || spt <= 0 || slab <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fpb = spt < NT ? NT / spt : 1;
  dim3 grid((F + fpb - 1) / fpb, (Lc + slab - 1) / slab);
  bwd_kernel<<<grid, NT, 0, s>>>(dirs, normal, h, albw, bary, onorm, inv2a,
                                 tables, Lc, F, spt, Bf, slab, use_gn,
                                 bin_lower, fine_res, partial);
  return (int)cudaGetLastError();
}
