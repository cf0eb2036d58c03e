// Fused occlusion + histogram splat for one source chunk (kernel K1).
//
// Replaces the JAX package's Pallas TPU kernel
// nlos_surface_optimization_tpu/render/fused_kernels.py::_fused_kernel
// (host side occluded_splat_pallas).  Rays are ordered (source, face,
// sample); one CUDA block owns 128 consecutive rays of one source.
//
// What bounds it on an H100: arithmetic.  Each live ray runs sign-safe
// Möller–Trumbore (~48 fp32 operations, no divide) against every face of
// its block's candidate groups; the ray data (40 B a ray) is read once.
// Design: the broad phase (8-face-group candidate lists, torch ops in the
// wrapper) cuts the face tests; the faces are read from global memory
// (L1/L2: every thread of a warp reads the same face, a broadcast); a ray
// stops at its first blocking face; dead rays (t_cut <= t_min, which no
// face can block) test nothing.  Compiled with -fmad=false so that each
// product and sum rounds as in the plain PyTorch version: the mask must
// match it exactly.
//
// The splat is deterministic (no float atomics): each block sorts its
// (bin, contribution) pairs (cub::BlockRadixSort, stable, so equal bins
// keep ray order), sums each run in order and writes one (bin, sum) pair
// per run; a second kernel, one block per source, adds the blocks' pairs
// into a shared-memory histogram block by block in index order (bins are
// distinct within a block, so the adds of one step never collide).

#include <cuda_runtime.h>
#include <cub/block/block_radix_sort.cuh>

namespace {

constexpr int RB = 128;        // rays per block
constexpr int GF = 8;          // faces per candidate group
constexpr int LIST_CAP = 1024; // largest candidate list a block can hold
constexpr int U = 8;           // blocks prefetched per step of the reduce

__global__ void __launch_bounds__(RB)
occl_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_self, const int* __restrict__ fid,
            const float* __restrict__ contrib, const int* __restrict__ bin,
            const float4* __restrict__ soup, const int* __restrict__ counts,
            const int* __restrict__ lists, int ka_max, int num_groups,
            int rs, int nbs, int Bf, int end_bit, float one_minus_trel,
            float t_min, float eps_det, unsigned char* __restrict__ occ,
            int* __restrict__ blk_bins, float* __restrict__ blk_vals) {
  using Sort = cub::BlockRadixSort<unsigned, RB, 1, float>;
  __shared__ typename Sort::TempStorage sort_tmp;
  __shared__ int s_list[LIST_CAP];
  __shared__ unsigned s_key[RB];
  __shared__ float s_val[RB];

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int l = b / nbs;
  const int local = (b - l * nbs) * RB + tid;
  const bool live = local < rs;
  const size_t r = (size_t)l * rs + local;

  const int cnt = counts[b];
  const bool full = cnt > ka_max;
  const int n = full ? num_groups : cnt;
  if (!full) {
    for (int i = tid; i < cnt; i += RB) s_list[i] = lists[(size_t)b * ka_max + i];
  }
  __syncthreads();

  bool occluded = false;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float t_cut = 0.f;
  int sfid = -1;
  if (live) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
    dx = d[3 * r]; dy = d[3 * r + 1]; dz = d[3 * r + 2];
    t_cut = t_self[r] * one_minus_trel;
    sfid = fid[r];
  }
  // t_cut <= t_min: tn > t_min*dd and tn < t_cut*dd cannot both hold
  if (live && t_cut > t_min) {
    for (int k = 0; k < n && !occluded; ++k) {
      const int g = full ? k : s_list[k];
      const float4* fp = soup + (size_t)g * GF * 3;
      for (int m = 0; m < GF; ++m) {
        const float4 A = __ldg(fp + 3 * m);
        const float4 B = __ldg(fp + 3 * m + 1);
        const float4 C = __ldg(fp + 3 * m + 2);
        const float p1x = A.x, p1y = A.y, p1z = A.z;
        const float e1x = A.w, e1y = B.x, e1z = B.y;
        const float e2x = B.z, e2y = B.w, e2z = C.x;
        const float val = C.y;
        const float pvx = dy * e2z - dz * e2y;
        const float pvy = dz * e2x - dx * e2z;
        const float pvz = dx * e2y - dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const float tvx = ox - p1x;
        const float tvy = oy - p1y;
        const float tvz = oz - p1z;
        const float u_num = tvx * pvx + tvy * pvy + tvz * pvz;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float v_num = dx * qvx + dy * qvy + dz * qvz;
        const float t_num = e2x * qvx + e2y * qvy + e2z * qvz;
        const float s = det >= 0.f ? 1.f : -1.f;
        const float dd = det * s;
        const float un = u_num * s;
        const float vn = v_num * s;
        const float tn = t_num * s;
        if (dd > eps_det && un >= 0.f && vn >= 0.f && un + vn <= dd &&
            val > 0.5f && tn > t_min * dd && tn < t_cut * dd &&
            g * GF + m != sfid) {
          occluded = true;
          break;
        }
      }
    }
  }
  if (live) occ[r] = occluded ? 1 : 0;

  // ---- deterministic per-block splat: sort by bin, sum each run in order
  unsigned key[1] = {(unsigned)Bf};
  float val[1] = {0.f};
  if (live && !occluded) {
    const float c = contrib[r];
    const int bb = bin[r];
    if (c != 0.f && bb >= 0 && bb < Bf) {
      key[0] = (unsigned)bb;
      val[0] = c;
    }
  }
  Sort(sort_tmp).Sort(key, val, 0, end_bit);
  s_key[tid] = key[0];
  s_val[tid] = val[0];
  __syncthreads();
  const unsigned kk = s_key[tid];
  int out_key = -1;
  float sum = 0.f;
  if (kk < (unsigned)Bf && (tid == 0 || s_key[tid - 1] != kk)) {
    sum = s_val[tid];
    for (int u = tid + 1; u < RB && s_key[u] == kk; ++u) sum += s_val[u];
    out_key = (int)kk;
  }
  blk_bins[(size_t)b * RB + tid] = out_key;
  blk_vals[(size_t)b * RB + tid] = sum;
}

__global__ void __launch_bounds__(RB)
splat_reduce_kernel(const int* __restrict__ blk_bins,
                    const float* __restrict__ blk_vals, int nbs, int Bf,
                    float* __restrict__ hist) {
  extern __shared__ float s_hist[];
  const int tid = threadIdx.x;
  const int l = blockIdx.x;
  for (int i = tid; i < Bf; i += RB) s_hist[i] = 0.f;
  __syncthreads();
  const size_t base = (size_t)l * nbs * RB + tid;
  for (int j0 = 0; j0 < nbs; j0 += U) {
    int kb[U];
    float vb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kb[u] = -1;
      vb[u] = 0.f;
      if (j0 + u < nbs) {
        kb[u] = blk_bins[base + (size_t)(j0 + u) * RB];
        vb[u] = blk_vals[base + (size_t)(j0 + u) * RB];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (kb[u] >= 0) s_hist[kb[u]] += vb[u];
      __syncthreads();
    }
  }
  for (int i = tid; i < Bf; i += RB) hist[(size_t)l * Bf + i] = s_hist[i];
}

}  // namespace

extern "C" int occluded_splat_launch(
    const float* o, const float* d, const float* t_self, const int* fid,
    const float* contrib, const int* bin, const float* soup,
    const int* counts, const int* lists, int ka_max, int num_groups, int Lc,
    int rs, int nbs, int Bf, float one_minus_trel, float t_min,
    float eps_det, unsigned char* occ, float* hist, int* blk_bins,
    float* blk_vals, void* stream) {
  if (ka_max > LIST_CAP || Lc <= 0 || nbs <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int end_bit = 1;
  while ((1 << end_bit) <= Bf) ++end_bit;  // sentinel Bf must fit
  occl_kernel<<<Lc * nbs, RB, 0, s>>>(
      o, d, t_self, fid, contrib, bin, reinterpret_cast<const float4*>(soup),
      counts, lists, ka_max, num_groups, rs, nbs, Bf, end_bit,
      one_minus_trel, t_min, eps_det, occ, blk_bins, blk_vals);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sizeof(float) * (size_t)Bf;
  e = cudaFuncSetAttribute(splat_reduce_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  splat_reduce_kernel<<<Lc, RB, smem, s>>>(blk_bins, blk_vals, nbs, Bf, hist);
  return (int)cudaGetLastError();
}
