// Segment occlusion for any set of rays (kernel K3).
//
// Replaces the JAX package's Pallas TPU kernel
// nlos_surface_optimization_tpu/render/pallas_kernels.py::_occl_kernel
// (host side segment_occluded_pallas).  occ[r] = 1 when another valid face
// crosses o -> o + d*t at t in (t_min, t_self*(1-t_rel)), by the same
// sign-safe Möller–Trumbore as K1 (mt_sign_safe.cuh), the ray's own face
// excluded.  Unlike K1 there is no splat and no grouping by source: the
// rays of a block may come from any origins, and the face count has no cap.
//
// What bounds it on an H100: arithmetic, as for K1.  Each live ray runs
// ~48 fp32 operations per face it is tested against; the ray data (32 B a
// ray) is read once and one byte a ray is written.  Design: one launch per
// call, one CUDA block per 128 rays, one thread per ray.  The block bounds
// its live rays (a block reduction; dead rays, t_self == 0, widen nothing)
// by the segment between the centres of their origin and endpoint boxes,
// widened by the larger half-extent, and runs K1's hierarchical broad
// phase and shared-memory narrow phase (hier_broad_phase.cuh) with that
// segment.  No reduction crosses blocks, so the mask is deterministic by
// construction.

#include <cuda_runtime.h>

#include "hier_broad_phase.cuh"

namespace {

using nst::kBlockRays;
constexpr int RB = kBlockRays;  // rays per block

__global__ void __launch_bounds__(RB)
segment_occluded_kernel(const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ t_self,
                        const int* __restrict__ fid,
                        const float4* __restrict__ soup,
                        const float* __restrict__ group_boxes,
                        const float* __restrict__ super_boxes, int ns,
                        int cap, int num_rays, float one_minus_trel,
                        float t_min, float eps_det,
                        unsigned char* __restrict__ occ,
                        int* __restrict__ counts) {
  __shared__ float s_red[nst::kWarps * 12];
  extern __shared__ float4 dyn[];
  const nst::HierShared sh = nst::carve(dyn, cap);

  const size_t r = (size_t)blockIdx.x * RB + threadIdx.x;
  const bool in_range = r < (size_t)num_rays;
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

  // the block's hull: origin box (0..2) and endpoint box (3..5) of its
  // live rays
  const bool live = in_range && ts > 0.f;
  float lo[6], hi[6];
  {
    const float x[6] = {ray.ox, ray.oy, ray.oz, ray.ox + ray.dx * ts,
                        ray.oy + ray.dy * ts, ray.oz + ray.dz * ts};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      lo[k] = live ? x[k] : CUDART_INF_F;
      hi[k] = live ? x[k] : -CUDART_INF_F;
    }
  }
  nst::block_minmax<6>(lo, hi, s_red);
  const bool block_live = __syncthreads_or(live);
  float a[3], b[3], half[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = 0.5f * (lo[k] + hi[k]);
    b[k] = 0.5f * (lo[3 + k] + hi[3 + k]);
    half[k] = fmaxf(0.5f * (hi[k] - lo[k]), 0.5f * (hi[3 + k] - lo[3 + k]));
  }
  const nst::Segment seg = nst::make_segment(a, b, half);
  const int listed = nst::hier_occlusion(sh, seg, block_live, group_boxes,
                                         super_boxes, soup, ns, cap, ray,
                                         t_min, eps_det);
  if (threadIdx.x == 0) counts[blockIdx.x] = listed;
  if (in_range) occ[r] = ray.occluded ? 1 : 0;
}

}  // namespace

// occ [num_rays] uint8, counts [ceil(num_rays/128)] int32 (groups listed
// per block, summed over passes).
extern "C" int segment_occluded_launch(
    const float* o, const float* d, const float* t_self, const int* fid,
    const float* soup, const float* group_boxes, const float* super_boxes,
    int ns, int cap, int num_rays, float one_minus_trel, float t_min,
    float eps_det, unsigned char* occ, int* counts, void* stream) {
  if (cap <= 0 || num_rays <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (num_rays + RB - 1) / RB;
  const size_t smem = nst::hier_smem_bytes(cap);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_occluded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  segment_occluded_kernel<<<blocks, RB, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      o, d, t_self, fid, reinterpret_cast<const float4*>(soup), group_boxes,
      super_boxes, ns, cap, num_rays, one_minus_trel, t_min, eps_det, occ,
      counts);
  return (int)cudaGetLastError();
}
