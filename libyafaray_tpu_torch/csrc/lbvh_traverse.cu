// Stack walk of a wavefront of rays through the linear BVH (the Karras tree
// of accel/lbvh.py), written for Hopper (sm_90a).
//
// The port's kernel with no Pallas counterpart: the JAX package walks the
// LBVH outside Pallas, as a vmapped per-lane while loop
// (libyafaray_tpu/accel/lbvh.py:259-335, traverse_closest / traverse_any).
//
// What it computes, per ray: the closest hit in (t_min, t_max] over the
// primitives whose visibility bit (1 camera and bounce rays, 2 shadow rays)
// is set and whose id differs from the ray's exclude id; an any-hit query
// stops at its first hit. Faces are tested with the port's Möller-Trumbore
// (ops/intersect.py moller_trumbore: each cross-product component
// a_i*b_j - a_j*b_i rounded once, from the exact double product, as the
// fused multiply-add XLA emits; vec.cross), spheres with its sphere test
// (accel/spheres.py intersect_sphere). MOTION = 1 blends a face's vertices
// per ray as v*(1-t) + v1*t, MOTION = 2 as the b-spline
// v*(1-t)^2 + v1*(2t(1-t)) + v2*t^2. Output t is t_max, prim -1 and
// u = v = 0 on a miss; u and v are 0 on a sphere.
//
// The walk, one thread per ray, as the plain version (lbvh_traverse_ref)
// and the JAX package do it, step for step:
//   * pop a node; its box test is tn <= tf && tf >= t_min && tn <= best_t,
//     with the slab distances from 1/d (each component of d held 1e-12
//     from 0) and min / max that carry a NaN as torch.minimum does;
//   * a leaf tests its primitive with t_max = best_t and takes it only on a
//     strictly lower t; an internal node pushes its far child and then its
//     near one, near being the left child when ltn <= rtn;
//   * the stack has MAX_STACK = 48 slots. A push past the last slot is
//     dropped while the pointer still grows, and a pop past it reads the
//     last slot: XLA drops an out-of-bounds scatter and clamps a gather,
//     and this kernel keeps the JAX package's walk on a tree that deep.
// Built with --fmad=false, every product and sum rounds on its own, as
// PyTorch's elementwise ops do, and the kernel equals its plain version bit
// for bit. A simple kernel first: the stack lives in local memory and the
// node records are read through the L1 cache.
//
// What bounds it: about 30 flops a box (two slab tests a step for the
// children, one for the popped node) and 45 to 90 a face test against 28
// bytes of node record a box; per ray the data decides how many nodes are
// visited, so the bound is counted from this run's walk (chip_smoke.py).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int MAX_STACK = 48;
constexpr float EPS_DET = 1e-10f;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// torch.minimum / torch.maximum: a NaN in either operand gives NaN
__device__ __forceinline__ float tmin2(float a, float b) {
  return (a != a || b != b) ? nan_f() : (a < b ? a : b);
}
__device__ __forceinline__ float tmax2(float a, float b) {
  return (a != a || b != b) ? nan_f() : (a > b ? a : b);
}

// a_i*b_j - a_j*b_i: the exact double product less the rounded float one,
// rounded once (vec.cross)
__device__ __forceinline__ float xcomp(float ai, float bj, float aj,
                                       float bi) {
  const double exact = (double)ai * (double)bj;
  const float q = aj * bi;
  return (float)(exact - (double)q);
}

struct Box {
  float tn, tf;
};

__device__ __forceinline__ Box slab(const float* __restrict__ nmin,
                                    const float* __restrict__ nmax, int node,
                                    const float o[3], const float inv[3]) {
  const int64_t b = (int64_t)node * 3;
  float tn = 0.f, tf = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t0 = (nmin[b + k] - o[k]) * inv[k];
    const float t1 = (nmax[b + k] - o[k]) * inv[k];
    const float lo = tmin2(t0, t1), hi = tmax2(t0, t1);
    tn = k ? tmax2(tn, lo) : lo;
    tf = k ? tmin2(tf, hi) : hi;
  }
  return {tn, tf};
}

template <int MOTION>
__device__ __forceinline__ void vertex(const float* __restrict__ v,
                                       const float* __restrict__ v1,
                                       const float* __restrict__ v2, int idx,
                                       float w0, float w1, float w2,
                                       float out[3]) {
  const int64_t b = (int64_t)idx * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (MOTION == 2)
      out[k] = v[b + k] * w0 + v1[b + k] * w1 + v2[b + k] * w2;
    else if (MOTION == 1)
      out[k] = v[b + k] * w0 + v1[b + k] * w1;
    else
      out[k] = v[b + k];
  }
}

template <int MOTION>
__global__ void __launch_bounds__(BLOCK) lbvh_traverse_kernel(
    const float* __restrict__ node_min, const float* __restrict__ node_max,
    const int* __restrict__ node_left, const int* __restrict__ node_right,
    const uint8_t* __restrict__ node_is_leaf,
    const int* __restrict__ prim_order, int n_prims,
    const float* __restrict__ verts, const float* __restrict__ verts_t1,
    const float* __restrict__ verts_t2, const int* __restrict__ faces,
    const int* __restrict__ face_vis, int n_faces,
    const float* __restrict__ sph_center,
    const float* __restrict__ sph_radius, const int* __restrict__ sph_vis,
    int n_spheres, int vis_bit, int any_hit, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ t_min,
    const float* __restrict__ t_max, const int* __restrict__ exclude,
    const float* __restrict__ time, int n, float* __restrict__ out_t,
    int* __restrict__ out_prim, float* __restrict__ out_u,
    float* __restrict__ out_v) {
  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float ro[3], rd[3], inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ro[k] = o[3 * i + k];
    rd[k] = d[3 * i + k];
    const float dk = rd[k];
    const float safe = fabsf(dk) < 1e-12f ? (dk < 0.f ? -1e-12f : 1e-12f)
                                          : dk;
    inv[k] = 1.0f / safe;
  }
  const float tmin = t_min[i];
  const int excl = exclude[i];
  // the blend weights of this ray's shutter time, in the plain version's
  // order
  float w0 = 1.f, w1 = 0.f, w2 = 0.f;
  if (MOTION) {
    const float tt = time[i];
    if (MOTION == 2) {
      w0 = (1.0f - tt) * (1.0f - tt);
      w1 = (2.0f * tt) * (1.0f - tt);
      w2 = tt * tt;
    } else {
      w0 = 1.0f - tt;
      w1 = tt;
    }
  }
  float best_t = t_max[i], best_u = 0.f, best_v = 0.f;
  int best_p = -1;
  int stack[MAX_STACK];
  stack[0] = 0;  // the root
  int sp = 1;
  bool done = false;
  while (sp > 0 && !done) {
    const int node = stack[min(sp - 1, MAX_STACK - 1)];
    sp -= 1;
    const Box bx = slab(node_min, node_max, node, ro, inv);
    const bool hit_box = bx.tn <= bx.tf && bx.tf >= tmin && bx.tn <= best_t;
    if (!hit_box) continue;
    const int lc = node_left[node];
    if (node_is_leaf[node]) {
      const int prim = prim_order[min(max(lc, 0), n_prims - 1)];
      bool hit = false;
      float t = 0.f, u = 0.f, v = 0.f;
      if (prim < n_faces) {
        const int64_t fb = (int64_t)prim * 3;
        float a[3], b[3], c[3];
        vertex<MOTION>(verts, verts_t1, verts_t2, faces[fb], w0, w1, w2, a);
        vertex<MOTION>(verts, verts_t1, verts_t2, faces[fb + 1], w0, w1, w2,
                       b);
        vertex<MOTION>(verts, verts_t1, verts_t2, faces[fb + 2], w0, w1, w2,
                       c);
        const float e1x = b[0] - a[0], e1y = b[1] - a[1], e1z = b[2] - a[2];
        const float e2x = c[0] - a[0], e2y = c[1] - a[1], e2z = c[2] - a[2];
        // pvec = d x e2
        const float pvx = xcomp(rd[1], e2z, rd[2], e2y);
        const float pvy = xcomp(rd[2], e2x, rd[0], e2z);
        const float pvz = xcomp(rd[0], e2y, rd[1], e2x);
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const bool ok = fabsf(det) > EPS_DET;
        const float inv_det = ok ? 1.0f / det : 0.0f;
        // tvec = o - v0
        const float tvx = ro[0] - a[0], tvy = ro[1] - a[1],
                    tvz = ro[2] - a[2];
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        // qvec = tvec x e1
        const float qvx = xcomp(tvy, e1z, tvz, e1y);
        const float qvy = xcomp(tvz, e1x, tvx, e1z);
        const float qvz = xcomp(tvx, e1y, tvy, e1x);
        v = (rd[0] * qvx + rd[1] * qvy + rd[2] * qvz) * inv_det;
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
        hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
              t <= best_t && (face_vis[prim] & vis_bit) != 0;
      } else if (prim - n_faces < n_spheres) {
        const int s = prim - n_faces;
        const float ocx = ro[0] - sph_center[3 * s];
        const float ocy = ro[1] - sph_center[3 * s + 1];
        const float ocz = ro[2] - sph_center[3 * s + 2];
        const float r = sph_radius[s];
        const float bb = ocx * rd[0] + ocy * rd[1] + ocz * rd[2];
        const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r;
        const float disc = bb * bb - cc;
        const float sq = sqrtf(tmax2(disc, 0.0f));
        const float t0 = -bb - sq, t1 = -bb + sq;
        const bool in0 = t0 > tmin && t0 <= best_t;
        const bool in1 = t1 > tmin && t1 <= best_t;
        t = in0 ? t0 : t1;
        hit = disc >= 0.0f && (in0 || in1) && (sph_vis[s] & vis_bit) != 0;
      }
      if (hit && prim != excl && t < best_t) {
        best_t = t;
        best_p = prim;
        best_u = u;
        best_v = v;
        done = any_hit != 0;
      }
    } else {
      const int rc = node_right[node];
      const float ltn = slab(node_min, node_max, lc, ro, inv).tn;
      const float rtn = slab(node_min, node_max, rc, ro, inv).tn;
      const bool first = ltn <= rtn;
      // far first, so that the near child pops first; a push past the
      // last slot is dropped and the pointer grows all the same
      if (sp < MAX_STACK) stack[sp] = first ? rc : lc;
      if (sp + 1 < MAX_STACK) stack[sp + 1] = first ? lc : rc;
      sp += 2;
    }
  }
  out_t[i] = best_t;
  out_prim[i] = best_p;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` without
// synchronising and returns cudaGetLastError() after the launch (0 = ok).
// node_min, node_max: f32[NN, 3]; node_left, node_right: i32[NN];
// node_is_leaf: bool[NN]; prim_order: i32[n_prims]; verts (and the motion
// keyframes verts_t1, verts_t2): f32[V, 3]; faces: i32[n_faces, 3];
// face_vis: i32[n_faces]; sph_center: f32[S, 3]; sph_radius: f32[S];
// sph_vis: i32[S]; o, d: f32[n, 3]; t_min, t_max, time: f32[n]; exclude:
// i32[n]; outputs f32/i32/f32/f32 [n].
extern "C" int lbvh_traverse_launch(
    const float* node_min, const float* node_max, const int* node_left,
    const int* node_right, const uint8_t* node_is_leaf, const int* prim_order,
    int n_prims, const float* verts, const float* verts_t1,
    const float* verts_t2, const int* faces, const int* face_vis, int n_faces,
    const float* sph_center, const float* sph_radius, const int* sph_vis,
    int n_spheres, int vis_bit, int any_hit, int motion, const float* o,
    const float* d, const float* t_min, const float* t_max,
    const int* exclude, const float* time, int n, float* out_t,
    int* out_prim, float* out_u, float* out_v, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LBVH_LAUNCH(M)                                                      \
  lbvh_traverse_kernel<M><<<grid, BLOCK, 0, s>>>(                           \
      node_min, node_max, node_left, node_right, node_is_leaf, prim_order,  \
      n_prims, verts, verts_t1, verts_t2, faces, face_vis, n_faces,         \
      sph_center, sph_radius, sph_vis, n_spheres, vis_bit, any_hit, o, d,   \
      t_min, t_max, exclude, time, n, out_t, out_prim, out_u, out_v)
  switch (motion) {
    case 0: LBVH_LAUNCH(0); break;
    case 1: LBVH_LAUNCH(1); break;
    case 2: LBVH_LAUNCH(2); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LBVH_LAUNCH
  return (int)cudaGetLastError();
}
