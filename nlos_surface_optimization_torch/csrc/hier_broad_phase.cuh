// The broad phase and the shared-memory narrow phase of kernels K1
// (occluded_splat.cu) and K3 (segment_occluded.cu), for one block of 128
// rays, one thread a ray.
//
// The wrapper puts the faces in Morton order, so 8 consecutive faces (a
// group) and 8 consecutive groups (a supergroup, 64 faces) are compact in
// space, and builds the face soup (12 floats a face, with the face's index
// in the mesh) and the boxes of both levels once per render
// (render/fused_kernels.face_hierarchy).
//
// Broad phase: the block bounds its live rays by one segment a -> b
// widened by a box of half-extents `half` (the kernel computes the hull).
// It slab-tests the supergroup boxes, one per thread, compacts the hits in
// increasing order (ballot and prefix scan over the block's 4 warps), then
// tests the 8 group boxes of each surviving supergroup and appends the hits,
// in increasing order, to a list in shared memory.  When the list holds
// `cap` groups the block runs the narrow phase on it and resumes the scan
// where it stopped: F has no cap, and no overflow falls back to a scan of
// every group.  Each step of the slab test is the plain version's
// (render/fused_kernels._slab_hits), so fused_kernels.hier_candidates
// gives each block's list and count exactly (built with -fmad=false).
//
// Narrow phase: the listed groups' faces (384 B a group, contiguous in the
// soup) go through a ring of kStages tiles of kTileGroups groups in shared
// memory, copied with cp.async so that the next tiles load while the
// current one is tested.  Every thread of a warp reads the same face
// (a broadcast).  Before a group's faces, each pending ray slab-tests the
// group's box (widened by 1e-5) against its own segment and tests the
// faces only when it crosses, so a warp runs a group's 8 faces only when
// one of its rays needs them (conservative: the mask stays the
// predicate's; fused_kernels.narrow_plain is its plain version, held to
// the every-face mask on the CPU, grazing hits on box faces included).
// A warp whose rays are all decided skips the tests
// (warp-uniform), and the block leaves the loop once every ray is decided.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "mt_sign_safe.cuh"

namespace nst {

constexpr int kBlockRays = 128;
constexpr int kWarps = kBlockRays / 32;
constexpr int kGroupsPerSuper = 8;
constexpr int kGroupF4 = kFacesPerGroup * 3;  // float4 of one group's faces
constexpr int kTileGroups = 8;
constexpr int kStages = 3;
constexpr int kTileF4 = kTileGroups * kGroupF4;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of one block whose list holds cap groups.
inline size_t hier_smem_bytes(int cap) {
  return sizeof(float4) * kStages * kTileF4 +
         sizeof(int) * ((size_t)cap + 2 * kBlockRays + kWarps);
}

struct HierShared {
  float4* tiles;  // [kStages][kTileF4] staged faces
  int* list;      // [cap] candidate groups of the current pass
  int* stage;     // [kBlockRays] one round's group hits
  int* supers;    // [kBlockRays] one round's supergroup hits
  int* warp_n;    // [kWarps] per-warp hit counts
};

__device__ __forceinline__ HierShared carve(float4* dyn, int cap) {
  HierShared s;
  s.tiles = dyn;
  s.list = reinterpret_cast<int*>(dyn + kStages * kTileF4);
  s.stage = s.list + cap;
  s.supers = s.stage + kBlockRays;
  s.warp_n = s.supers + kBlockRays;
  return s;
}

// Segment a -> b widened by half, prepared for slab tests.
struct Segment {
  float a[3], inv[3], w[3];
  bool par[3];
};

__device__ __forceinline__ Segment make_segment(const float (&a)[3],
                                                const float (&b)[3],
                                                const float (&half)[3]) {
  Segment s;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ab = b[k] - a[k];
    s.a[k] = a[k];
    s.par[k] = fabsf(ab) <= 1e-30f;
    s.inv[k] = s.par[k] ? 0.f : 1.f / ab;
    s.w[k] = half[k] + 1e-5f;
  }
  return s;
}

// The segment crosses box lo | hi (6 floats) widened by half + 1e-5; an
// empty box (lo > hi on an axis) is never crossed.
__device__ __forceinline__ bool slab_hit(const Segment& s,
                                         const float* __restrict__ box) {
  const float b0 = box[0], b1 = box[1], b2 = box[2];
  const float b3 = box[3], b4 = box[4], b5 = box[5];
  if (b0 > b3 || b1 > b4 || b2 > b5) return false;
  const float lo_box[3] = {b0, b1, b2};
  const float hi_box[3] = {b3, b4, b5};
  float enter = 0.f, leave = 1.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = lo_box[k] - s.w[k];
    const float hi = hi_box[k] + s.w[k];
    float tmin, tmax;
    if (s.par[k]) {
      const bool inside = s.a[k] >= lo && s.a[k] <= hi;
      tmin = inside ? -CUDART_INF_F : CUDART_INF_F;
      tmax = inside ? CUDART_INF_F : -CUDART_INF_F;
    } else {
      const float t0 = (lo - s.a[k]) * s.inv[k];
      const float t1 = (hi - s.a[k]) * s.inv[k];
      tmin = fminf(t0, t1);
      tmax = fmaxf(t0, t1);
    }
    enter = fmaxf(enter, tmin);
    leave = fminf(leave, tmax);
  }
  return enter <= leave;
}

// Block-wide min of lo[] and max of hi[] (N values each), in every thread.
// red: shared scratch of kWarps * 2N floats.
template <int N>
__device__ __forceinline__ void block_minmax(float (&lo)[N], float (&hi)[N],
                                             float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo[k] = fminf(lo[k], __shfl_xor_sync(kFull, lo[k], off));
      hi[k] = fmaxf(hi[k], __shfl_xor_sync(kFull, hi[k], off));
    }
    if (lane == 0) {
      red[w * 2 * N + k] = lo[k];
      red[w * 2 * N + N + k] = hi[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    lo[k] = red[k];
    hi[k] = red[N + k];
    for (int u = 1; u < kWarps; ++u) {
      lo[k] = fminf(lo[k], red[u * 2 * N + k]);
      hi[k] = fmaxf(hi[k], red[u * 2 * N + N + k]);
    }
  }
}

// Writes the values of the threads whose pred holds to out[0..), in thread
// order; returns their number (in every thread).
__device__ __forceinline__ int block_compact(bool pred, int value, int* out,
                                             int* warp_n) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(kFull, pred);
  if (lane == 0) warp_n[w] = __popc(m);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int u = 0; u < kWarps; ++u) {
    const int c = warp_n[u];
    off += u < w ? c : 0;
    total += c;
  }
  if (pred) out[off + __popc(m & ((1u << lane) - 1u))] = value;
  __syncthreads();
  return total;
}

// One thread's ray.  pending: live (t_cut > t_min) and not yet occluded;
// seg: o -> o + d*t_cut for the per-ray group cull (set_ray).
struct Ray {
  float ox, oy, oz, dx, dy, dz, t_cut;
  int sfid;
  bool pending, occluded;
  Segment seg;
};

__device__ __forceinline__ void set_ray(Ray& r, float t_min) {
  const float a[3] = {r.ox, r.oy, r.oz};
  const float b[3] = {r.ox + r.dx * r.t_cut, r.oy + r.dy * r.t_cut,
                      r.oz + r.dz * r.t_cut};
  const float zero[3] = {0.f, 0.f, 0.f};
  r.seg = make_segment(a, b, zero);
  r.pending = r.t_cut > t_min;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of tile t of the n listed groups into its ring slot.
__device__ __forceinline__ void load_tile(const HierShared& sh,
                                          const float4* __restrict__ soup,
                                          int n, int t) {
  float4* dst = sh.tiles + (t % kStages) * kTileF4;
  const int first = t * kTileGroups;
  const int cnt = min(kTileGroups, n - first) * kGroupF4;
  for (int i = threadIdx.x; i < cnt; i += kBlockRays) {
    const int k = i / kGroupF4;
    cp_async16(dst + i,
               soup + (size_t)sh.list[first + k] * kGroupF4 + (i - k * kGroupF4));
  }
}

// Test every pending ray of the block against the faces of the n groups
// in sh.list.  Every thread of the block calls it.
__device__ __forceinline__ void narrow_pass(
    const HierShared& sh, const float* __restrict__ group_boxes,
    const float4* __restrict__ soup, int n, Ray& r, float t_min,
    float eps_det) {
  if (!__syncthreads_or(r.pending)) return;
  const int tiles = (n + kTileGroups - 1) / kTileGroups;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) load_tile(sh, soup, n, t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    if (t + kStages - 1 < tiles) load_tile(sh, soup, n, t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile t has landed (this thread's part)
    __syncthreads();               // ... and every thread's
    if (__any_sync(kFull, r.pending)) {
      const float4* tile = sh.tiles + (t % kStages) * kTileF4;
      const int groups = min(kTileGroups, n - t * kTileGroups);
      for (int k = 0; k < groups; ++k) {
        const int g = sh.list[t * kTileGroups + k];
        const bool need =
            r.pending && slab_hit(r.seg, group_boxes + 6 * (size_t)g);
        if (!need) continue;  // a group no ray of the warp needs costs one test
        const float4* fp = tile + k * kGroupF4;
        for (int m = 0; m < kFacesPerGroup; ++m) {
          if (face_blocks(fp[3 * m], fp[3 * m + 1], fp[3 * m + 2], r.ox, r.oy,
                          r.oz, r.dx, r.dy, r.dz, r.t_cut, t_min, eps_det,
                          r.sfid)) {
            r.pending = false;
            r.occluded = true;
            break;
          }
        }
      }
    }
    // every ray decided: stop; the barrier also frees slot t for tile t+3
    if (!__syncthreads_or(r.pending)) break;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The whole hierarchical test of one block: scan the ns supergroups,
// narrow phase on each full list and on the rest.  Returns the number of
// groups listed, summed over the passes (the same in every thread).
__device__ __forceinline__ int hier_occlusion(
    const HierShared& sh, const Segment& seg, bool block_live,
    const float* __restrict__ group_boxes,
    const float* __restrict__ super_boxes, const float4* __restrict__ soup,
    int ns, int cap, Ray& r, float t_min, float eps_det) {
  if (!block_live) return 0;
  int listed = 0, n = 0;
  for (int s0 = 0; s0 < ns; s0 += kBlockRays) {
    const int s = s0 + threadIdx.x;
    const bool hit_s = s < ns && slab_hit(seg, super_boxes + 6 * (size_t)s);
    const int nsup = block_compact(hit_s, s, sh.supers, sh.warp_n);
    for (int j0 = 0; j0 < nsup * kGroupsPerSuper; j0 += kBlockRays) {
      const int j = j0 + threadIdx.x;
      int g = 0;
      bool hit_g = false;
      if (j < nsup * kGroupsPerSuper) {
        g = sh.supers[j / kGroupsPerSuper] * kGroupsPerSuper +
            j % kGroupsPerSuper;
        hit_g = slab_hit(seg, group_boxes + 6 * (size_t)g);
      }
      const int nhit = block_compact(hit_g, g, sh.stage, sh.warp_n);
      for (int used = 0; used < nhit;) {
        const int take = min(cap - n, nhit - used);
        for (int i = threadIdx.x; i < take; i += kBlockRays)
          sh.list[n + i] = sh.stage[used + i];
        n += take;
        used += take;
        __syncthreads();
        if (n == cap) {
          narrow_pass(sh, group_boxes, soup, n, r, t_min, eps_det);
          listed += n;
          n = 0;
        }
      }
    }
  }
  if (n > 0) {
    narrow_pass(sh, group_boxes, soup, n, r, t_min, eps_det);
    listed += n;
  }
  return listed;
}

}  // namespace nst
