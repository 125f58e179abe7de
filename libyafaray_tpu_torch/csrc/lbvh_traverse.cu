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
// The walk, one thread per ray, is the plain version's (lbvh_traverse_ref)
// and the JAX package's, step for step:
//   * pop a node; its box test is tn <= tf && tf >= t_min && tn <= best_t,
//     with the slab distances from 1/d (each component of d held 1e-12
//     from 0) and min / max that carry a NaN as torch.minimum does;
//   * a leaf tests its primitive with t_max = best_t and takes it only on a
//     strictly lower t, so on an exact tie the leaf popped first wins; an
//     internal node pushes its far child and then its near one, near being
//     the left child when ltn <= rtn;
//   * the stack has MAX_STACK = 48 slots. A push past the last slot is
//     dropped while the pointer still grows, and a pop past it reads the
//     last slot: XLA drops an out-of-bounds scatter and clamps a gather,
//     and this kernel keeps the JAX package's walk on a tree that deep.
//
// What bounds it. A step is a few dependent loads and 25-90 flops, and the
// data decides how many steps a ray takes, so the bound is counted from
// this run's walk (chip_smoke.py): the box, face and sphere tests the walk
// needed at their flops, or every input read once. The kernel stays far
// from it: every product is unfused and issued on its own, each step's
// loads wait for the step before, and a warp runs as long as its longest
// ray while its lanes split between leaves and internal nodes. So the
// design cuts instructions and loads a step, and idle lanes.
//
// What the design does about it, each item exact by construction:
//   1. Packed child-pair records (accel/lbvh.py pack_lbvh, built once per
//      tree and geometry): an internal node's 64-byte record holds both
//      children's boxes and codes (a child's own record row, or ~slot for a
//      leaf), read as four 16-byte loads. A box is read once, when its
//      parent is entered, instead of once there and again at its pop. The
//      boxes are copies of the same floats, so every tn and tf is the same.
//      The root's box and code sit apart (it is nobody's child; a
//      one-primitive tree's root is a leaf).
//   2. Each pushed child carries its tn on the stack. The terms
//      tn <= tf && tf >= t_min of its box test do not depend on best_t and
//      are evaluated at the push; a child that fails them is still pushed,
//      so the pointer and the overflow behave as before, but marked dead in
//      a 64-bit mask of live slots. The pop tests tn <= best_t against the
//      current best_t, loading nothing; at or below slot 48 a run of dead
//      entries is popped at once (__clzll on the mask): they could change
//      nothing. Past slot 48 the pop re-reads the last slot one at a time,
//      as the plain walk does. The near child is pushed and popped at once,
//      so it stays in registers unless its push would be dropped.
//   3. Primitives in leaf order, built with the records: leaf slot s holds
//      prim_order[s]'s 48-byte record (v0, e1 = v1 - v0, e2 = v2 - v0, the
//      prim id and its visibility bits; a sphere's centre, radius and bits),
//      so a leaf is one run of 16-byte loads instead of a chain of four
//      dependent ones. e1 and e2 are the same single IEEE subtraction of
//      the same floats. The motion arms keep blend-then-subtract
//      (blend(v1) - blend(v0) is not blend(v1 - v0) in rounding): their
//      keyframe vertices sit in leaf order, unsubtracted.
//   4. Dead rays out before the walk. A block writes (t_max, -1, 0, 0) for
//      its rays with !(t_max > t_min) and packs its live rays to its first
//      warps (a ballot a warp, a shared counter), so that a warp walks live
//      rays only; a ray with a NaN in o or d leaves at the walk's start. A
//      hit needs t > t_min and t < best_t <= t_max, which no t meets, and a
//      NaN in o or d makes det, u or the sphere's discriminant NaN, which
//      fails every leaf test. Each ray's walk depends on no other ray, so
//      the order the rays take in the block changes no result.
//   5. The face test skips its excluded prim and a face without the ray's
//      visibility bit (each is ANDed into the hit), takes 1/det as
//      __frcp_rn (IEEE 1/x), and stops after det and u when
//      !ok || !(u >= 0) || u > 1: with v >= 0, u > 1 gives u + v > 1 under
//      round to nearest, so such a face is never hit.
//   6. Where the tree's boxes (a flag in the root record) and the ray's o
//      and d are finite, no slab distance can be NaN, and the slab test
//      takes fminf / fmaxf: the same values up to the sign of a zero, which
//      no comparison of tn or tf sees (-0 == +0). Other rays keep the
//      NaN-carrying min / max.
// Tried on the card and not kept, as they did not pay (PERF.md §6):
// the stack in shared memory, persistent warps, blocks of 64 or 256, a
// minimum of 10 or 12 blocks an SM in __launch_bounds__ (48 or 40
// registers, and spills), the ray direction's doubles hoisted out of the
// face test, and reordering a query's rays across blocks (a morton sort, a
// stable compaction, a global list of live rays, tiles of 2-8 blocks'
// rays). Blocks of 128 threads take 56 registers, 9 blocks an SM.
//
// Built with --fmad=false, every product and sum rounds on its own, as
// PyTorch's elementwise ops do, and xcomp keeps the cross products' exact
// double product as the port's vec.cross does: both keep this kernel equal
// to its plain version bit for bit, and through it to the JAX walk.
// Tensor cores do not apply: a step is a handful of scalar dot products
// whose operands come from the walk's own dependent loads, with no matrix
// to tile, and their reduced-precision products would change the bits.
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

// the slab test's min / max: FAST where no operand can be NaN (the tree's
// boxes and the ray's o and d finite), where fminf / fmaxf give the same
// value up to the sign of a zero, which no comparison of tn or tf sees
template <bool FAST>
__device__ __forceinline__ float mn(float a, float b) {
  return FAST ? fminf(a, b) : tmin2(a, b);
}
template <bool FAST>
__device__ __forceinline__ float mx(float a, float b) {
  return FAST ? fmaxf(a, b) : tmax2(a, b);
}

struct Slab {
  float tn, tf;
};

// the slab distances of the box (lo.xyz, hi.xyz), in the plain version's
// order of axes
template <bool FAST>
__device__ __forceinline__ Slab slab(float4 lo, float4 hi, const float o[3],
                                     const float inv[3]) {
  const float x0 = (lo.x - o[0]) * inv[0], x1 = (hi.x - o[0]) * inv[0];
  const float y0 = (lo.y - o[1]) * inv[1], y1 = (hi.y - o[1]) * inv[1];
  const float z0 = (lo.z - o[2]) * inv[2], z1 = (hi.z - o[2]) * inv[2];
  float tn = mn<FAST>(x0, x1), tf = mx<FAST>(x0, x1);
  tn = mx<FAST>(tn, mn<FAST>(y0, y1));
  tf = mn<FAST>(tf, mx<FAST>(y0, y1));
  tn = mx<FAST>(tn, mn<FAST>(z0, z1));
  tf = mn<FAST>(tf, mx<FAST>(z0, z1));
  return {tn, tf};
}

// one keyframe blend of a corner, in the plain version's order
template <int MOTION>
__device__ __forceinline__ void blend(const float4* __restrict__ rec, int k,
                                      float w0, float w1, float w2,
                                      float out[3]) {
  const float4 a = __ldg(rec + k);
  if (MOTION == 0) {
    out[0] = a.x, out[1] = a.y, out[2] = a.z;
    return;
  }
  const float4 b = __ldg(rec + 3 + k);
  if (MOTION == 1) {
    out[0] = a.x * w0 + b.x * w1;
    out[1] = a.y * w0 + b.y * w1;
    out[2] = a.z * w0 + b.z * w1;
    return;
  }
  const float4 c = __ldg(rec + 6 + k);
  out[0] = a.x * w0 + b.x * w1 + c.x * w2;
  out[1] = a.y * w0 + b.y * w1 + c.y * w2;
  out[2] = a.z * w0 + b.z * w1 + c.z * w2;
}

// one query's tables, rays and outputs (the C entry point's arguments)
struct Query {
  const float4* nodes;    // internal nodes' child-pair records
  const float4* root;     // the root's box and code
  const float4* leaves;   // leaf records, static or keyframes
  int n_faces, n_spheres, vis_bit, any_hit;
  const float* o;
  const float* d;
  const float* t_min;
  const float* t_max;
  const int* exclude;
  const float* time;
  int n;
  float* out_t;
  int* out_prim;
  float* out_u;
  float* out_v;
};

// ray i's walk (FAST: see mn)
template <int MOTION, bool FAST>
__device__ __forceinline__ void walk(const Query& q, int64_t i) {
  const float4* __restrict__ nodes = q.nodes;
  const float4* __restrict__ leaves = q.leaves;
  const float* __restrict__ o = q.o;
  const float* __restrict__ d = q.d;
  const int n_faces = q.n_faces, n_spheres = q.n_spheres;
  const int vis_bit = q.vis_bit, any_hit = q.any_hit;
  float* __restrict__ out_t = q.out_t;
  int* __restrict__ out_prim = q.out_prim;
  float* __restrict__ out_u = q.out_u;
  float* __restrict__ out_v = q.out_v;
  float ro[3], rd[3], inv[3];
  bool nan_ray = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ro[k] = o[3 * i + k];
    rd[k] = d[3 * i + k];
    nan_ray = nan_ray || ro[k] != ro[k] || rd[k] != rd[k];
  }
  const float tmin = q.t_min[i];
  float best_t = q.t_max[i], best_u = 0.f, best_v = 0.f;
  int best_p = -1;
  // item 4: a ray with a NaN in o or d leaves before the walk (the kernel
  // walks no ray whose range is empty)
  if (nan_ray) {
    out_t[i] = best_t;
    out_prim[i] = -1;
    out_u[i] = 0.f;
    out_v[i] = 0.f;
    return;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dk = rd[k];
    const float safe = fabsf(dk) < 1e-12f ? (dk < 0.f ? -1e-12f : 1e-12f)
                                          : dk;
    inv[k] = 1.0f / safe;
  }
  const int excl = q.exclude[i];
  // the blend weights of this ray's shutter time, in the plain version's
  // order
  float w0 = 1.f, w1 = 0.f, w2 = 0.f;
  if (MOTION) {
    const float tt = q.time[i];
    if (MOTION == 2) {
      w0 = (1.0f - tt) * (1.0f - tt);
      w1 = (2.0f * tt) * (1.0f - tt);
      w2 = tt * tt;
    } else {
      w0 = 1.0f - tt;
      w1 = tt;
    }
  }
  // the entry in hand: a node's code, its tn and whether the best_t-free
  // terms of its box test held; the root first
  const float4 root_lo = __ldg(q.root), root_hi = __ldg(q.root + 1);
  const Slab rb = slab<FAST>(root_lo, root_hi, ro, inv);
  int code = __float_as_int(root_lo.w);
  float ctn = rb.tn;
  bool alive = rb.tn <= rb.tf && rb.tf >= tmin;
  int2 stack[MAX_STACK];   // (code, tn bits)
  uint64_t live = 0;       // bit k: slot k's entry passed its push test
  int sp = 0;              // the plain walk's pointer, the root popped
  for (;;) {
    if (alive && ctn <= best_t) {
      if (code < 0) {
        // a leaf: its record in leaf order
        const float4* rec = leaves + (int64_t)(~code) * (3 * (MOTION + 1));
        const float4 head = __ldg(rec), head1 = __ldg(rec + 1);
        const int prim = __float_as_int(head.w);
        const int vis = __float_as_int(head1.w);
        bool hit = false;
        float t = 0.f, u = 0.f, v = 0.f;
        if (prim == excl || (vis & vis_bit) == 0) {
          // ANDed into the hit: nothing to test
        } else if (prim < n_faces) {
          float a[3], e1[3], e2[3];
          if (MOTION == 0) {
            const float4 q2 = __ldg(rec + 2);
            a[0] = head.x, a[1] = head.y, a[2] = head.z;
            e1[0] = head1.x, e1[1] = head1.y, e1[2] = head1.z;
            e2[0] = q2.x, e2[1] = q2.y, e2[2] = q2.z;
          } else {
            float b[3], c[3];
            blend<MOTION>(rec, 0, w0, w1, w2, a);
            blend<MOTION>(rec, 1, w0, w1, w2, b);
            blend<MOTION>(rec, 2, w0, w1, w2, c);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              e1[k] = b[k] - a[k];
              e2[k] = c[k] - a[k];
            }
          }
          // pvec = d x e2
          const float pvx = xcomp(rd[1], e2[2], rd[2], e2[1]);
          const float pvy = xcomp(rd[2], e2[0], rd[0], e2[2]);
          const float pvz = xcomp(rd[0], e2[1], rd[1], e2[0]);
          const float det = e1[0] * pvx + e1[1] * pvy + e1[2] * pvz;
          const bool ok = fabsf(det) > EPS_DET;
          const float inv_det = ok ? __frcp_rn(det) : 0.0f;
          // tvec = o - v0
          const float tvx = ro[0] - a[0], tvy = ro[1] - a[1],
                      tvz = ro[2] - a[2];
          u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
          if (ok && u >= 0.0f && !(u > 1.0f)) {
            // qvec = tvec x e1
            const float qvx = xcomp(tvy, e1[2], tvz, e1[1]);
            const float qvy = xcomp(tvz, e1[0], tvx, e1[2]);
            const float qvz = xcomp(tvx, e1[1], tvy, e1[0]);
            v = (rd[0] * qvx + rd[1] * qvy + rd[2] * qvz) * inv_det;
            t = (e2[0] * qvx + e2[1] * qvy + e2[2] * qvz) * inv_det;
            hit = v >= 0.0f && u + v <= 1.0f && t > tmin && t <= best_t;
          }
        } else if (prim - n_faces < n_spheres) {
          const float ocx = ro[0] - head.x;
          const float ocy = ro[1] - head.y;
          const float ocz = ro[2] - head.z;
          const float r = head1.x;
          const float bb = ocx * rd[0] + ocy * rd[1] + ocz * rd[2];
          const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r;
          const float disc = bb * bb - cc;
          const float sq = sqrtf(tmax2(disc, 0.0f));
          const float t0 = -bb - sq, t1 = -bb + sq;
          const bool in0 = t0 > tmin && t0 <= best_t;
          const bool in1 = t1 > tmin && t1 <= best_t;
          t = in0 ? t0 : t1;
          u = v = 0.f;
          hit = disc >= 0.0f && (in0 || in1);
        }
        if (hit && t < best_t) {
          best_t = t;
          best_p = prim;
          best_u = u;
          best_v = v;
          if (any_hit) break;
        }
      } else {
        // an internal node: both children from its record
        const float4* rec = nodes + (int64_t)code * 4;
        const float4 l_lo = __ldg(rec), l_hi = __ldg(rec + 1);
        const float4 r_lo = __ldg(rec + 2), r_hi = __ldg(rec + 3);
        const Slab l = slab<FAST>(l_lo, l_hi, ro, inv);
        const Slab r = slab<FAST>(r_lo, r_hi, ro, inv);
        const bool l_alive = l.tn <= l.tf && l.tf >= tmin;
        const bool r_alive = r.tn <= r.tf && r.tf >= tmin;
        const int l_code = __float_as_int(l_lo.w);
        const int r_code = __float_as_int(l_hi.w);
        const bool first = l.tn <= r.tn;
        // far first, so that the near child pops first; a push past the
        // last slot is dropped and the pointer grows all the same
        if (sp < MAX_STACK) {
          stack[sp] = first ? make_int2(r_code, __float_as_int(r.tn))
                            : make_int2(l_code, __float_as_int(l.tn));
          const uint64_t bit = 1ull << sp;
          live = (first ? r_alive : l_alive) ? (live | bit) : (live & ~bit);
        }
        if (sp + 1 < MAX_STACK) {
          // the near child's push and its pop at once
          sp += 1;
          code = first ? l_code : r_code;
          ctn = first ? l.tn : r.tn;
          alive = first ? l_alive : r_alive;
          continue;
        }
        sp += 2;
      }
    }
    // pop
    if (sp > MAX_STACK) {
      // past the last slot: it is read again, one entry at a time
      sp -= 1;
      const int2 e = stack[MAX_STACK - 1];
      code = e.x;
      ctn = __int_as_float(e.y);
      alive = (live >> (MAX_STACK - 1)) & 1;
      continue;
    }
    // slots [0, sp): the dead entries above the top live one go at once
    const uint64_t m = live & ((1ull << sp) - 1);
    if (m == 0) break;
    sp = 63 - __clzll((long long)m);
    const int2 e = stack[sp];
    code = e.x;
    ctn = __int_as_float(e.y);
    alive = true;
  }
  out_t[i] = best_t;
  out_prim[i] = best_p;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

template <int MOTION>
__global__ void __launch_bounds__(BLOCK) lbvh_traverse_kernel(const Query q) {
  // item 4: the block's dead rays (!(t_max > t_min)) are written at once
  // and its live rays packed to the front of the block, a warp's lanes
  // kept together, so that the block's warps hold live rays only and the
  // rest end here
  __shared__ int live_ids[BLOCK];
  __shared__ int n_live;
  if (threadIdx.x == 0) n_live = 0;
  __syncthreads();
  const int64_t first = (int64_t)blockIdx.x * BLOCK;
  const int64_t mine = first + threadIdx.x;
  bool live = false;
  if (mine < q.n) {
    live = q.t_max[mine] > q.t_min[mine];
    if (!live) {
      q.out_t[mine] = q.t_max[mine];
      q.out_prim[mine] = -1;
      q.out_u[mine] = 0.f;
      q.out_v[mine] = 0.f;
    }
  }
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && mask) base = atomicAdd(&n_live, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (live) live_ids[base + __popc(mask & ((1u << lane) - 1))] = threadIdx.x;
  __syncthreads();
  if ((int)threadIdx.x >= n_live) return;
  const int64_t i = first + live_ids[threadIdx.x];
  // item 6: the root record's last word says whether every box is finite
  bool finite = __float_as_int(__ldg(q.root + 1).w) != 0;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    finite = finite && isfinite(q.o[3 * i + k]) && isfinite(q.d[3 * i + k]);
  if (finite)
    walk<MOTION, true>(q, i);
  else
    walk<MOTION, false>(q, i);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` without
// synchronising and returns cudaGetLastError() after the launch (0 = ok).
// nodes: i32[max(N_int, 1), 16], root: i32[8], leaves: i32[P, 12] (the
// static records) or i32[P, 12 (motion + 1)] (the keyframes), as
// accel/lbvh.py pack_lbvh lays them out; o, d: f32[n, 3]; t_min, t_max,
// time: f32[n]; exclude: i32[n]; outputs f32/i32/f32/f32 [n].
extern "C" int lbvh_packed_launch(
    const void* nodes, const void* root, const void* leaves, int n_faces,
    int n_spheres, int vis_bit, int any_hit, int motion, const float* o,
    const float* d, const float* t_min, const float* t_max,
    const int* exclude, const float* time, int n, float* out_t,
    int* out_prim, float* out_u, float* out_v, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Query q{static_cast<const float4*>(nodes),
                static_cast<const float4*>(root),
                static_cast<const float4*>(leaves),
                n_faces, n_spheres, vis_bit, any_hit, o, d, t_min, t_max,
                exclude, time, n, out_t, out_prim, out_u, out_v};
#define LBVH_LAUNCH(M) lbvh_traverse_kernel<M><<<grid, BLOCK, 0, s>>>(q)
  switch (motion) {
    case 0: LBVH_LAUNCH(0); break;
    case 1: LBVH_LAUNCH(1); break;
    case 2: LBVH_LAUNCH(2); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LBVH_LAUNCH
  return (int)cudaGetLastError();
}
