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
// ~48 fp32 operations per face of its block's candidate groups; the ray
// data (32 B a ray) is read once and one byte a ray is written.  Design:
// one CUDA block per 128 rays, one thread per ray.  The broad phase (torch
// ops in the wrapper, render/occl_kernels.py) gives each block a list of
// 8-face groups whose boxes its swept ray hull touches; the block copies
// its list to shared memory and reads the groups' faces from global memory
// (L1/L2; every thread of a warp reads the same face, a broadcast).  A
// block whose list overflowed scans every group, so correctness never
// depends on the list's capacity.  A ray stops at its first blocking face;
// a dead ray (t_cut <= t_min, which no face can block) tests nothing.  No
// reduction crosses blocks, so the mask is deterministic by construction.

#include <cuda_runtime.h>

#include "mt_sign_safe.cuh"

namespace {

constexpr int RB = 128;         // rays per block
constexpr int LIST_CAP = 1024;  // largest candidate list a block can hold

__global__ void __launch_bounds__(RB)
segment_occluded_kernel(const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ t_self,
                        const int* __restrict__ fid,
                        const float4* __restrict__ soup,
                        const int* __restrict__ counts,
                        const int* __restrict__ lists, int ka_max,
                        int num_groups, int num_rays, float one_minus_trel,
                        float t_min, float eps_det,
                        unsigned char* __restrict__ occ) {
  __shared__ int s_list[LIST_CAP];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const size_t r = (size_t)b * RB + tid;
  const bool live = r < (size_t)num_rays;

  const int cnt = counts[b];
  const bool full = cnt > ka_max;
  const int n = full ? num_groups : cnt;
  if (!full) {
    for (int i = tid; i < cnt; i += RB) s_list[i] = lists[(size_t)b * ka_max + i];
  }
  __syncthreads();
  if (!live) return;

  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float t_cut = t_self[r] * one_minus_trel;
  const int sfid = fid[r];
  bool occluded = false;
  // t_cut <= t_min: tn > t_min*dd and tn < t_cut*dd cannot both hold
  if (t_cut > t_min) {
    for (int k = 0; k < n && !occluded; ++k) {
      occluded = nst::group_blocks(soup, full ? k : s_list[k], ox, oy, oz,
                                   dx, dy, dz, t_cut, t_min, eps_det, sfid);
    }
  }
  occ[r] = occluded ? 1 : 0;
}

}  // namespace

extern "C" int segment_occluded_launch(
    const float* o, const float* d, const float* t_self, const int* fid,
    const float* soup, const int* counts, const int* lists, int ka_max,
    int num_groups, int num_rays, float one_minus_trel, float t_min,
    float eps_det, unsigned char* occ, void* stream) {
  if (ka_max > LIST_CAP || num_rays <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (num_rays + RB - 1) / RB;
  segment_occluded_kernel<<<blocks, RB, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, t_self, fid, reinterpret_cast<const float4*>(soup), counts, lists,
      ka_max, num_groups, num_rays, one_minus_trel, t_min, eps_det, occ);
  return (int)cudaGetLastError();
}
