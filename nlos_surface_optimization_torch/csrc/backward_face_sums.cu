// Fused analytic backward for one source chunk: the per-face gradient
// sums (kernel K2) and the face -> vertex epilogue.
//
// Replaces the JAX package's Pallas TPU kernel
// nlos_surface_optimization_tpu/render/bwd_kernels.py::_bwd_kernel
// (wrapper backward_face_sums_pallas) with its XLA prep (the tap tables
// of render/core.py::_tap_tables, albw, inv2a), and the XLA epilogue of
// its backward_chunk_fused (cross products, face -> vertex segment sum).
//
// face_sums_kernel, per ray (ordered source, face, sample): the fine bin
// q = floor((2h - bin_lower)/fine_res); a ray with q outside [0, Bf] gets
// A = Bw = 0.  Else qs = q - rsig, p = qs mod refine, b0 = floor(qs /
// refine) (floored as numpy floors them) and, from the source's row d of
// the coarse weighted difference,
//     A  = sum_j W[p,j]  * d[b0+j]     j = 0 .. G-1 in order, from zero,
//     Bw = sum_j WD[p,j] * d[b0+j]     d = 0 outside [0, B)
// -- the products and sums that build the tap tables, so A and Bw equal
// a table lookup bit for bit.  Then albw = albedo*valid*area*(-2/spt),
// the Lambertian t1, t2 (+ the shading-normal term gn when use_gn) give
// P = t1*A + dir*inten*Bw*(2/sigma^2) and S2 = t2*A; per face, summed
// over a slab's sources and the face's samples: P*b1, P*b2, P*b3, S2
// (12 floats), written as the slab's partial sums.
//
// vertex_epilogue_kernel, one warp per vertex: it walks the vertex's
// (face, slot) entries in the order of a stable sort of f.reshape(-1) (a
// CSR built once per render, padding faces left out); lane i computes
// entry i of each run of 32 (the entry's slab partials summed in slab
// order, plus cross(S2 sum, the edge opposite the slot)), then the lanes
// add the run's entries in index order through shuffles, and lane 0
// writes the sum or adds it into the running gradient.
//
// What bounds them on an H100: memory.  A ray is read once (33 bytes; 45
// with a per-ray shading normal) for ~150 flops; the difference rows and
// the tap weights are small and reused by every face tile.  Design: the
// grid is face tiles x source slabs, the slab chosen by the wrapper for ~8
// blocks a SM; each thread owns one (face, sample) slot of its block's
// tile, loads what depends on the face only once, and keeps its 12 sums
// in registers over the slab's sources; for one source the tile's rays
// are contiguous, so the loads coalesce.  The taps read the source's
// difference row (4.8 KB at 1,200 bins) through L1 and the phase tables
// W, WD from shared memory: no barrier inside the source loop.  (An
// earlier version staged each source's window of the row in shared
// memory, behind a block min/max of b0 and two barriers a source: it was
// slower at every case measured.)  A face's samples are added once, at
// the end of the block, in slot order.  No float atomics: the epilogue
// adds the slabs in order, so the result is the same from run to run.
// Compiled with -fmad=false to round as the plain versions do.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;        // threads a block, one (face, sample) slot each
constexpr int NV = 12;         // per-face terms
constexpr int RED = NT + 1;    // row stride of the final reduction (banks)

__global__ void __launch_bounds__(NT)
face_sums_kernel(const float* __restrict__ dirs, const float* __restrict__ hh,
                 const float* __restrict__ albedo,
                 const unsigned char* __restrict__ valid,
                 const float* __restrict__ bary,
                 const float* __restrict__ normal,
                 const float* __restrict__ area,
                 const float* __restrict__ onorm,
                 const float* __restrict__ diff,
                 const float* __restrict__ wtab, int Lc, int F, int spt,
                 int slab, int B, int refine, int G, int rsig,
                 int per_ray_normal, int use_gn, float bin_lower,
                 float fine_res, float alb_scale, float bw_scale,
                 float* __restrict__ partial) {
  extern __shared__ float s_wtab[];    // W [refine*G] | WD [refine*G]
  __shared__ float s_red[NV * RED];
  const int tid = threadIdx.x;
  const int fpb = spt < NT ? NT / spt : 1;
  const int f0 = blockIdx.x * fpb;
  const int nf = min(fpb, F - f0);
  const int n = nf * spt;
  const int l0 = blockIdx.y * slab;
  const int l1 = min(Lc, l0 + slab);
  const int RG = refine * G;
  const int Bf = B * refine;
  for (int i = tid; i < 2 * RG; i += NT) s_wtab[i] = wtab[i];
  __syncthreads();
  // the face of this thread's slots (one face a block when a face has
  // more samples than the block has threads) and what depends on it only
  const int face = f0 + (n > NT ? 0 : min(tid, n - 1) / spt);
  const float ar = area[face];
  const float inv2a = 1.f / (2.f * fmaxf(ar, 1e-30f));
  float fnx = 0.f, fny = 0.f, fnz = 0.f;
  if (!per_ray_normal) {
    fnx = normal[3 * face];
    fny = normal[3 * face + 1];
    fnz = normal[3 * face + 2];
  }

  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;

  for (int l = l0; l < l1; ++l) {
    const float ox = onorm[3 * l], oy = onorm[3 * l + 1], oz = onorm[3 * l + 2];
    const float* drow = diff + (size_t)l * B;
    const size_t base = ((size_t)l * F + f0) * spt;
    // one slot a thread unless a face has more samples than the block
    for (int s = tid; s < n; s += NT) {
      const size_t r = base + s;
      const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
      const float h = hh[r];
      const float alb = albedo[r] * (valid[r] ? 1.f : 0.f);
      const float b1 = bary[3 * r], b2 = bary[3 * r + 1], b3 = bary[3 * r + 2];
      float nx = fnx, ny = fny, nz = fnz;
      if (per_ray_normal) {
        nx = normal[3 * r]; ny = normal[3 * r + 1]; nz = normal[3 * r + 2];
      }

      // taps: the source's difference row is a few KB, read through L1
      const float qf = floorf((2.f * h - bin_lower) / fine_res);
      float A = 0.f, Bw = 0.f;
      if (fabsf(qf) < 2.0e9f && qf >= 0.f && qf <= (float)Bf) {
        const int qs = (int)qf - rsig;
        const int b0 = qs >= 0 ? qs / refine : -((refine - 1 - qs) / refine);
        const int p = qs - b0 * refine;
        const float* w = s_wtab + p * G;
        const float* wd = s_wtab + RG + p * G;
        for (int j = 0; j < G; ++j) {
          const int b = b0 + j;
          const float d = (b >= 0 && b < B) ? __ldg(drow + b) : 0.f;
          A = A + w[j] * d;
          Bw = Bw + wd[j] * d;
        }
      }
      Bw = Bw * bw_scale;
      const float albw = alb * ar * alb_scale;

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
      acc[0] += px * b1; acc[1] += py * b1; acc[2] += pz * b1;
      acc[3] += px * b2; acc[4] += py * b2; acc[5] += pz * b2;
      acc[6] += px * b3; acc[7] += py * b3; acc[8] += pz * b3;
      acc[9] += t2x * A; acc[10] += t2y * A; acc[11] += t2z * A;
    }
  }

  // a face's samples, added in slot order; threads past the last slot
  // hold zeros
#pragma unroll
  for (int k = 0; k < NV; ++k) s_red[k * RED + tid] = acc[k];
  __syncthreads();
  const int nthr = min(n, NT);
  for (int q = tid; q < nf * NV; q += NT) {
    const int fl = q / NV;
    const int k = q - fl * NV;
    const int t1 = min((fl + 1) * spt, nthr);
    float sum = 0.f;
    for (int t = fl * spt; t < t1; ++t) sum += s_red[k * RED + t];
    partial[((size_t)blockIdx.y * F + f0 + fl) * NV + k] = sum;
  }
}

// One warp a vertex: lane i computes the vertex's entry i of each run of
// 32 (slab sums, cross product, slot vector), then every lane adds the
// run's entries in index order through shuffles.
__global__ void __launch_bounds__(NT)
vertex_epilogue_kernel(const float* __restrict__ partial, int nslab, int F,
                       const float* __restrict__ v,
                       const long long* __restrict__ f,
                       const int* __restrict__ offsets,
                       const int* __restrict__ entries, int V, int add,
                       float* __restrict__ out) {
  const int vi = (blockIdx.x * NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (vi >= V) return;               // the whole warp
  const size_t slab_stride = (size_t)F * NV;
  const int e0 = offsets[vi], e1 = offsets[vi + 1];
  float gx = 0.f, gy = 0.f, gz = 0.f;
  for (int c = e0; c < e1; c += 32) {
    float cx = 0.f, cy = 0.f, cz = 0.f;
    if (c + lane < e1) {
      const int ent = entries[c + lane];
      const int face = ent / 3;
      const int k = ent - 3 * face;
      const float* p = partial + (size_t)face * NV;
      float px = p[3 * k], py = p[3 * k + 1], pz = p[3 * k + 2];
      float tx = p[9], ty = p[10], tz = p[11];
      for (int sl = 1; sl < nslab; ++sl) {
        const float* q = p + sl * slab_stride;
        px = px + q[3 * k]; py = py + q[3 * k + 1]; pz = pz + q[3 * k + 2];
        tx = tx + q[9]; ty = ty + q[10]; tz = tz + q[11];
      }
      // the edge opposite slot k: (v3 - v2, v1 - v3, v2 - v1)
      const float* va = v + 3 * f[3 * (size_t)face + (k + 2) % 3];
      const float* vb = v + 3 * f[3 * (size_t)face + (k + 1) % 3];
      const float ex = va[0] - vb[0], ey = va[1] - vb[1], ez = va[2] - vb[2];
      cx = px + (ty * ez - tz * ey);
      cy = py + (tz * ex - tx * ez);
      cz = pz + (tx * ey - ty * ex);
    }
    const int cnt = min(32, e1 - c);
    for (int i = 0; i < cnt; ++i) {
      gx = gx + __shfl_sync(0xffffffffu, cx, i);
      gy = gy + __shfl_sync(0xffffffffu, cy, i);
      gz = gz + __shfl_sync(0xffffffffu, cz, i);
    }
  }
  if (lane == 0) {
    if (add) {
      out[3 * vi] = out[3 * vi] + gx;
      out[3 * vi + 1] = out[3 * vi + 1] + gy;
      out[3 * vi + 2] = out[3 * vi + 2] + gz;
    } else {
      out[3 * vi] = gx;
      out[3 * vi + 1] = gy;
      out[3 * vi + 2] = gz;
    }
  }
}

}  // namespace

extern "C" int backward_face_sums_launch(
    const float* dirs, const float* h, const float* albedo,
    const unsigned char* valid, const float* bary, const float* normal,
    const float* area, const float* onorm, const float* diff,
    const float* wtab, int Lc, int F, int spt, int slab, int B, int refine,
    int G, int rsig, int per_ray_normal, int use_gn, float bin_lower,
    float fine_res, float alb_scale, float bw_scale, float* partial,
    void* stream) {
  if (Lc <= 0 || F <= 0 || spt <= 0 || slab <= 0 || B <= 0 || refine <= 0 ||
      G <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fpb = spt < NT ? NT / spt : 1;
  const dim3 grid((F + fpb - 1) / fpb, (Lc + slab - 1) / slab);
  const size_t smem = (size_t)(2 * refine * G) * sizeof(float);
  face_sums_kernel<<<grid, NT, smem, s>>>(
      dirs, h, albedo, valid, bary, normal, area, onorm, diff, wtab, Lc, F,
      spt, slab, B, refine, G, rsig, per_ray_normal, use_gn, bin_lower,
      fine_res, alb_scale, bw_scale, partial);
  return (int)cudaGetLastError();
}

extern "C" int vertex_epilogue_launch(const float* partial, int nslab, int F,
                                      const float* v, const long long* f,
                                      const int* offsets, const int* entries,
                                      int V, int add, float* out,
                                      void* stream) {
  if (nslab <= 0 || F <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  vertex_epilogue_kernel<<<(int)(((size_t)V * 32 + NT - 1) / NT), NT, 0, s>>>(
      partial, nslab, F, v, f, offsets, entries, V, add, out);
  return (int)cudaGetLastError();
}
