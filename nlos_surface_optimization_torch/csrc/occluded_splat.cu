// Fused occlusion + histogram splat for one source chunk (kernel K1).
//
// Replaces the JAX package's Pallas TPU kernel
// nlos_surface_optimization_tpu/render/fused_kernels.py::_fused_kernel
// (host side occluded_splat_pallas).  Rays are ordered (source, face,
// sample); one CUDA block owns 128 consecutive rays of one source.
//
// What bounds it on an H100: arithmetic.  Each live ray runs sign-safe
// Möller–Trumbore (~48 fp32 operations, no divide; mt_sign_safe.cuh,
// shared with K3) against the faces whose boxes its segment crosses; the
// ray data (40 B a ray) is read once.  Design (hier_broad_phase.cuh): the
// block bounds its live rays by the segment from its source to the box of
// their endpoints (a block reduction; dead rays, t_self == 0, widen
// nothing), finds the 8-face groups that segment's swept box touches over
// a two-level hierarchy of the Morton-ordered faces (64-face supergroups,
// then their groups), and tests its rays against those groups' faces,
// staged through shared memory with cp.async.  A ray stops at its first
// blocking face; dead rays (t_cut <= t_min, which no face can block) test
// nothing.  Compiled with -fmad=false so that each product and sum rounds
// as in the plain PyTorch version: the mask must match it exactly.
//
// The splat is deterministic (no float atomics): each block sorts its
// (bin, contribution) pairs (cub::BlockRadixSort, stable, so equal bins
// keep ray order), sums each run in order and writes one (bin, sum) pair
// per run.  The reduce kernel runs one block per (bin range, source, slab
// of 128 blocks' runs): it adds the slab's pairs that fall in its range
// into a shared-memory histogram, block by block in index order (bins are
// distinct within a block, so the adds of one step never collide); a last
// kernel adds the slabs' partial histograms in slab order.  Every bin gets
// the same adds in the same order whatever the ranges, so the histogram is
// bit-identical for any split and from run to run.

#include <cuda_runtime.h>
#include <cub/block/block_radix_sort.cuh>

#include "hier_broad_phase.cuh"

namespace {

using nst::kBlockRays;
constexpr int RB = kBlockRays;  // rays per block
constexpr int U = 8;            // blocks prefetched per step of the reduce

__global__ void __launch_bounds__(RB)
occl_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_self, const int* __restrict__ fid,
            const float* __restrict__ contrib, const int* __restrict__ bin,
            const float4* __restrict__ soup,
            const float* __restrict__ group_boxes,
            const float* __restrict__ super_boxes, int ns, int cap, int rs,
            int nbs, int Bf, int end_bit, float one_minus_trel, float t_min,
            float eps_det, unsigned char* __restrict__ occ,
            int* __restrict__ counts, int* __restrict__ blk_bins,
            float* __restrict__ blk_vals) {
  using Sort = cub::BlockRadixSort<unsigned, RB, 1, float>;
  __shared__ typename Sort::TempStorage sort_tmp;
  __shared__ unsigned s_key[RB];
  __shared__ float s_val[RB];
  __shared__ float s_red[nst::kWarps * 6];
  extern __shared__ float4 dyn[];
  const nst::HierShared sh = nst::carve(dyn, cap);

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int l = b / nbs;
  const int local = (b - l * nbs) * RB + tid;
  const bool in_range = local < rs;
  const size_t r = (size_t)l * rs + local;

  nst::Ray ray{};
  float ts = 0.f;
  if (in_range) {
    ray.ox = o[3 * r]; ray.oy = o[3 * r + 1]; ray.oz = o[3 * r + 2];
    ray.dx = d[3 * r]; ray.dy = d[3 * r + 1]; ray.dz = d[3 * r + 2];
    ts = t_self[r];
    ray.t_cut = ts * one_minus_trel;
    ray.sfid = fid[r];
  }
  // t_cut <= t_min: tn > t_min*dd and tn < t_cut*dd cannot both hold
  nst::set_ray(ray, t_min);
  ray.pending = ray.pending && in_range;

  // the block's hull: its source to the box of its live endpoints
  const bool live = in_range && ts > 0.f;
  float lo[3], hi[3];
  {
    const float p[3] = {ray.ox + ray.dx * ts, ray.oy + ray.dy * ts,
                        ray.oz + ray.dz * ts};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = live ? p[k] : CUDART_INF_F;
      hi[k] = live ? p[k] : -CUDART_INF_F;
    }
  }
  nst::block_minmax<3>(lo, hi, s_red);
  const bool block_live = __syncthreads_or(live);
  const size_t r0 = (size_t)l * rs;
  const float a[3] = {o[3 * r0], o[3 * r0 + 1], o[3 * r0 + 2]};
  float e[3], half[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e[k] = 0.5f * (lo[k] + hi[k]);
    half[k] = 0.5f * (hi[k] - lo[k]);
  }
  const nst::Segment seg = nst::make_segment(a, e, half);
  const int listed = nst::hier_occlusion(sh, seg, block_live, group_boxes,
                                         super_boxes, soup, ns, cap, ray,
                                         t_min, eps_det);
  if (tid == 0) counts[b] = listed;
  const bool occluded = ray.occluded;
  if (in_range) occ[r] = occluded ? 1 : 0;

  // ---- deterministic per-block splat: sort by bin, sum each run in order
  unsigned key[1] = {(unsigned)Bf};
  float val[1] = {0.f};
  if (in_range && !occluded) {
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

// One block per (bin range, source, slab): the runs of source l's blocks
// [z*slab, (z+1)*slab) that fall in bins [lo, lo + width), added block by
// block in index order, to out[l, z, lo:lo + width] (out [Lc, slabs, Bf];
// hist itself when there is one slab).
__global__ void __launch_bounds__(RB)
splat_reduce_kernel(const int* __restrict__ blk_bins,
                    const float* __restrict__ blk_vals, int nbs, int Bf,
                    int width, int slab, float* __restrict__ out) {
  extern __shared__ float s_hist[];
  const int tid = threadIdx.x;
  const int l = blockIdx.y;
  const int z = blockIdx.z;
  const int lo = blockIdx.x * width;
  const int n = min(width, Bf - lo);
  const int j_end = min(nbs, (z + 1) * slab);
  for (int i = tid; i < n; i += RB) s_hist[i] = 0.f;
  __syncthreads();
  const size_t base = (size_t)l * nbs * RB + tid;
  for (int j0 = z * slab; j0 < j_end; j0 += U) {
    int kb[U];
    float vb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kb[u] = -1;
      vb[u] = 0.f;
      if (j0 + u < j_end) {
        const size_t at = base + (size_t)(j0 + u) * RB;
        const int k = blk_bins[at] - lo;
        if (k >= 0 && k < n) {
          kb[u] = k;
          vb[u] = blk_vals[at];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (kb[u] >= 0) s_hist[kb[u]] += vb[u];
      __syncthreads();
    }
  }
  float* dst = out + ((size_t)l * gridDim.z + z) * Bf + lo;
  for (int i = tid; i < n; i += RB) dst[i] = s_hist[i];
}

// hist[l, k] = the slabs' partial sums of bin k, added in slab order.
__global__ void splat_sum_kernel(const float* __restrict__ partial,
                                 int slabs, int Lc, int Bf,
                                 float* __restrict__ hist) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)Lc * Bf) return;
  const size_t l = i / Bf, k = i - l * Bf;
  const float* p = partial + l * slabs * Bf + k;
  float s = p[0];
  for (int z = 1; z < slabs; ++z) s += p[(size_t)z * Bf];
  hist[i] = s;
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// Occlusion and per-block splat runs: occ [Lc*rs], counts [Lc*nbs] (groups
// listed per block, summed over passes), blk_bins / blk_vals [Lc*nbs*128].
extern "C" int occluded_splat_occlusion_launch(
    const float* o, const float* d, const float* t_self, const int* fid,
    const float* contrib, const int* bin, const float* soup,
    const float* group_boxes, const float* super_boxes, int ns, int cap,
    int Lc, int rs, int nbs, int Bf, float one_minus_trel, float t_min,
    float eps_det, unsigned char* occ, int* counts, int* blk_bins,
    float* blk_vals, void* stream) {
  if (cap <= 0 || Lc <= 0 || nbs <= 0) return (int)cudaErrorInvalidValue;
  int end_bit = 1;
  while ((1 << end_bit) <= Bf) ++end_bit;  // sentinel Bf must fit
  const size_t smem = nst::hier_smem_bytes(cap);
  cudaError_t e = allow_smem((const void*)occl_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  occl_kernel<<<Lc * nbs, RB, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, t_self, fid, contrib, bin, reinterpret_cast<const float4*>(soup),
      group_boxes, super_boxes, ns, cap, rs, nbs, Bf, end_bit, one_minus_trel,
      t_min, eps_det, occ, counts, blk_bins, blk_vals);
  return (int)cudaGetLastError();
}

// hist [Lc, Bf] from the block runs: `ranges` bin ranges per source, slabs
// of `slab` blocks' runs (partial: Lc * ceil(nbs/slab) * Bf floats when
// there is more than one slab), then the slabs added in order.
extern "C" int occluded_splat_reduce_launch(const int* blk_bins,
                                            const float* blk_vals, int Lc,
                                            int nbs, int Bf, int ranges,
                                            int slab, float* partial,
                                            float* hist, void* stream) {
  if (Lc <= 0 || nbs <= 0 || Bf <= 0 || ranges <= 0 || slab <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = (Bf + ranges - 1) / ranges;
  const int used = (Bf + width - 1) / width;
  const int slabs = (nbs + slab - 1) / slab;
  const size_t smem = sizeof(float) * (size_t)width;
  cudaError_t e = allow_smem((const void*)splat_reduce_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  splat_reduce_kernel<<<dim3(used, Lc, slabs), RB, smem, s>>>(
      blk_bins, blk_vals, nbs, Bf, width, slab, slabs > 1 ? partial : hist);
  e = cudaGetLastError();
  if (e != cudaSuccess || slabs == 1) return (int)e;
  const int threads = 256;
  const size_t total = (size_t)Lc * Bf;
  splat_sum_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                     s>>>(partial, slabs, Lc, Bf, hist);
  return (int)cudaGetLastError();
}
