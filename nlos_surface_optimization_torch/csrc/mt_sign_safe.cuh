// The narrow phase shared by kernels K1 (occluded_splat.cu) and K3
// (segment_occluded.cu): sign-safe Möller–Trumbore of one ray against one
// 8-face group of the face soup.
//
// The soup holds 12 floats a face (p1 | e1 | e2 | valid | 0 0), read as
// three float4.  The test divides nothing: the sign of det folds into each
// inequality.  Build with -fmad=false so every product and sum rounds on
// its own, as in the plain PyTorch version (fused_kernels.sign_safe_blocked):
// the masks must match it exactly.
#pragma once

namespace nst {

constexpr int kFacesPerGroup = 8;

// True when a valid face of group g, other than face sfid, crosses the ray
// o + d*t at some t in (t_min, t_cut).  Roughly 48 fp32 operations a face.
__device__ __forceinline__ bool group_blocks(
    const float4* __restrict__ soup, int g, float ox, float oy, float oz,
    float dx, float dy, float dz, float t_cut, float t_min, float eps_det,
    int sfid) {
  const float4* fp = soup + (size_t)g * kFacesPerGroup * 3;
  for (int m = 0; m < kFacesPerGroup; ++m) {
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
        g * kFacesPerGroup + m != sfid) {
      return true;
    }
  }
  return false;
}

}  // namespace nst
