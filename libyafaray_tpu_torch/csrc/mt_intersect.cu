// Möller-Trumbore closest hit of a wavefront of rays against a packed
// triangle table, written for Hopper (sm_90a).
//
// Replaces: libyafaray_tpu/accel/pallas_intersect.py::_mt_kernel (the Pallas
// TPU kernel behind mt_closest), which carries every closest-hit and shadow
// query of scenes with 1..16384 faces. Here it carries every brute-force
// query, whatever the face count: table offsets are 64-bit (row * 16 as
// int64_t) and rows and rays are counted in int, so a 203,522-row table and
// 2M rays are well inside its range.
//
// What it computes, per ray: the lowest t in (t_min, t_max) over all table
// rows whose visibility column (9 = camera/bounce, 10 = shadow) is > 0.5 and
// whose prim id differs from the ray's exclude id. On an exact t tie the
// lowest row (the lowest prim id) wins, with u/v from that triangle. Output
// t is t_max, prim -1 and u = v = 0 on a miss. With MOTION = 1 the three
// vertices are blended per ray as c0*(1-tt) + c1*tt; with MOTION = 2 as the
// quadratic b-spline c0*(1-tt)^2 + c1*(2*tt*(1-tt)) + c2*tt^2.
//
// What bounds it on an H100. About 45 flops per ray-triangle pair (72 and
// 90 with the linear and quadratic blends) against 36 bytes of ray state in
// and 16 bytes of hit record out per ray: at the tables this path sees (36
// triangles for the Cornell box, 203,522 for the terrain) that is far above
// the card's ratio of flops to bytes. The limit is the instructions issued
// per pair: the file is built with --fmad=false, so every product and sum
// rounds on its own as PyTorch's elementwise ops do, and that is what keeps
// the kernel equal to its plain version (mt_closest_ref) bit for bit. Tensor
// cores do not apply: TF32 and bf16 products do not round as fp32 IEEE
// products do. The design cuts the pairs tested and the instructions per
// pair, and keeps every rounding step:
//   * one thread per ray, BLOCK rays per block, the ray in registers; the
//     table is streamed through shared memory in chunks of BLOCK rows, one
//     row per thread, and all threads then read the same row (a broadcast,
//     free of bank conflicts). A 16384-row table (1 MiB) does not fit in
//     shared memory, hence the streaming;
//   * only the rows the query can hit are staged: a row whose selected
//     visibility column is not > 0.5 (padding, camera-invisible faces, the
//     lamp quads of a shadow query) is dropped while its chunk is staged
//     (a warp ballot and a prefix count of the kept rows before it). Such a
//     row can never pass the hit test, and the kept rows keep their order,
//     so the scan below still meets tied hits lowest row first. The Cornell
//     table's 64 rows become 36 for camera and bounce rays and 34 for shadow
//     rays;
//   * static arm: the row is staged as v0, e1 = v1 - v0 and e2 = v2 - v0 (12
//     floats in three 16-byte words): each edge is the one subtraction of
//     the same two floats that every ray did before, so it has the same
//     bits, and the pair loop loads three float4s and subtracts nothing.
//     The motion arms blend per ray first and subtract after (a blend of a
//     difference does not round as a difference of blends); they stage the
//     keyframes' vertices and the id in 16-byte words (5 and 7 a row);
//   * the reciprocal 1/det is __frcp_rn, IEEE round to nearest: for
//     |det| > EPS_DET it is the same correctly rounded value as the
//     division 1/det, and the kernel takes 0 otherwise, as 0/1 was;
//   * a warp stops a pair after det and u unless one of its rays has ok and
//     0 <= u <= 1 (a warp vote, so the branch is uniform): qvec, v and t
//     are computed only for the rest, and the hit test still asks for ok
//     and 0 <= u. Exact: with v >= 0 and u > 1, u + v rounds to a value
//     >= u > 1 (rounding to nearest is monotone), so such a pair failed the
//     test before as well. The stop pays on coherent queries (camera rays,
//     where a warp's rays often all fail u) and costs a few percent on
//     incoherent ones, where some ray of a warp nearly always passes;
//   * a ray with an empty range (not t_max > t_min: dead paths and unneeded
//     shadow rays, as the integrator marks them) gets the miss at once: no t
//     can pass t > t_min && t < t_max, so the full scan gave the same. When
//     a block's remaining live rays fit in fewer warps than hold them, they
//     are packed, in ray order, into its first threads (a ballot and a
//     prefix count); a warp left without a live ray skips the pair loop and
//     only takes part in staging and the barriers. The deep wavefronts of a
//     path tracer are 6-50% live, scattered over the image, so packing, and
//     not the skip of a warp that happens to be all dead, is what cuts them;
//   * the pair loop is unrolled four times, and the accepted hit is the
//     first in row order with a strict t < best_t, which reproduces the
//     plain version's tie-break (the lowest row among hits at the lowest t)
//     without a reduction.
// Measured and left out (tools/time_mt_closest.py): two rays a thread,
// blocks of 256, a persistent grid that stages a one-chunk table once,
// the table in __constant__ memory and cp.async double-buffered staging
// were each no faster on the Cornell queries, and the constant table and
// the persistent grid were slower.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;   // rays per block, one thread each
constexpr int CHUNK = BLOCK; // table rows read per step, one per thread
constexpr int NWARP = BLOCK / 32;
constexpr int ROW = 16;      // floats per packed table row
constexpr float EPS_DET = 1e-10f;
constexpr unsigned FULL = 0xffffffffu;

// 16-byte words per staged row: v0, e1, e2, id (static); the keyframes'
// vertices and the id (motion)
template <int MOTION>
__host__ __device__ constexpr int row_words() {
  return MOTION == 0 ? 3 : (9 * (MOTION + 1) + 1 + 3) / 4;
}

template <int MOTION>
__global__ void __launch_bounds__(BLOCK) mt_closest_kernel(
    const float* __restrict__ tris, const float* __restrict__ tris_t1,
    const float* __restrict__ tris_t2, int rows, int vis_col,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    const int* __restrict__ exclude, const float* __restrict__ time, int n,
    float* __restrict__ out_t, int* __restrict__ out_prim,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  constexpr int W = row_words<MOTION>();
  constexpr int ID = MOTION == 0 ? 9 : 9 * (MOTION + 1);  // float index
  __shared__ float4 s_row[CHUNK][W];
  __shared__ int s_kept[NWARP];
  __shared__ int s_live[NWARP];
  __shared__ int s_src[BLOCK];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  float ox, oy, oz, dx, dy, dz, tmin, best_t, tt;
  int excl;
  auto load_ray = [&](bool has) {
    ox = oy = oz = dx = dy = dz = tmin = tt = 0.f;
    best_t = -1.f;
    excl = -1;
    if (has) {
      ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
      dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
      tmin = t_min[i];
      best_t = t_max[i];
      excl = exclude[i];
      if (MOTION) tt = time[i];
    }
  };
  load_ray(i < n);
  // a ray with an empty range misses: its result is written here
  bool live = best_t > tmin;
  if (i < n && !live) {
    out_t[i] = best_t;
    out_prim[i] = -1;
    out_u[i] = 0.f;
    out_v[i] = 0.f;
  }
  const unsigned live_mask = __ballot_sync(FULL, live);
  if (lane == 0) s_live[warp] = __popc(live_mask);
  __syncthreads();
  int n_live = 0, busy = 0, slot = __popc(live_mask & ((1u << lane) - 1u));
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    n_live += s_live[w];
    busy += s_live[w] > 0;
    if (w < warp) slot += s_live[w];
  }
  if ((n_live + 31) / 32 < busy) {
    // the live rays fit in fewer warps than hold them: thread k takes the
    // k-th live ray, in ray order
    if (live) s_src[slot] = threadIdx.x;
    __syncthreads();
    live = threadIdx.x < n_live;
    i = (int64_t)blockIdx.x * BLOCK + (live ? s_src[threadIdx.x] : 0);
    load_ray(live);
  }
  int best_id = -1;
  float best_u = 0.f, best_v = 0.f;
  // per-ray blend weights, in the Pallas kernel's order
  const float tc = 1.0f - tt;
  const float w0 = MOTION == 2 ? tc * tc : tc;
  const float w1 = MOTION == 2 ? (2.0f * tt) * tc : tt;
  const float w2 = tt * tt;
  // no ray of the warp has a range: nothing to find
  const bool warp_dead = __all_sync(FULL, !live);

  for (int base = 0; base < rows; base += CHUNK) {
    // this thread's row of the chunk, and whether the query can hit it
    const int g = base + threadIdx.x;
    const float* src = tris + (int64_t)g * ROW;
    const bool keep = g < rows && src[vis_col] > 0.5f;
    const unsigned ballot = __ballot_sync(FULL, keep);
    // every thread read s_kept before the last chunk's second barrier
    if (lane == 0) s_kept[warp] = __popc(ballot);
    __syncthreads();  // and every thread is done with the last chunk's rows
    int at = __popc(ballot & ((1u << lane) - 1u)), cnt = 0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      if (w < warp) at += s_kept[w];
      cnt += s_kept[w];
    }
    if (keep) {
      float f[4 * W];
#pragma unroll
      for (int k = 0; k < 4 * W; ++k) f[k] = 0.0f;
      if (MOTION == 0) {
        const float ax = src[0], ay = src[1], az = src[2];
        f[0] = ax; f[1] = ay; f[2] = az;
        f[3] = src[3] - ax; f[4] = src[4] - ay; f[5] = src[5] - az;
        f[6] = src[6] - ax; f[7] = src[7] - ay; f[8] = src[8] - az;
      } else {
        const int64_t off = (int64_t)g * ROW;
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          f[c] = src[c];
          f[9 + c] = tris_t1[off + c];
          if (MOTION == 2) f[18 + c] = tris_t2[off + c];
        }
      }
      f[ID] = __int_as_float((int)src[11]);
#pragma unroll
      for (int k = 0; k < W; ++k)
        s_row[at][k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2],
                                   f[4 * k + 3]);
    }
    __syncthreads();
    if (warp_dead) continue;
#pragma unroll 4
    for (int r = 0; r < cnt; ++r) {
      float f[4 * W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float4 q = s_row[r][k];
        f[4 * k] = q.x; f[4 * k + 1] = q.y; f[4 * k + 2] = q.z;
        f[4 * k + 3] = q.w;
      }
      float ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z;
      if (MOTION == 0) {
        ax = f[0]; ay = f[1]; az = f[2];
        e1x = f[3]; e1y = f[4]; e1z = f[5];
        e2x = f[6]; e2y = f[7]; e2z = f[8];
      } else {
        float v[9];
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          if (MOTION == 2)
            v[c] = f[c] * w0 + f[9 + c] * w1 + f[18 + c] * w2;
          else
            v[c] = f[c] * w0 + f[9 + c] * w1;
        }
        ax = v[0]; ay = v[1]; az = v[2];
        e1x = v[3] - ax; e1y = v[4] - ay; e1z = v[5] - az;
        e2x = v[6] - ax; e2y = v[7] - ay; e2z = v[8] - az;
      }
      // pvec = d x e2
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const bool ok = fabsf(det) > EPS_DET;
      const float inv_det = ok ? __frcp_rn(det) : 0.0f;
      // tvec = o - v0
      const float tvx = ox - ax, tvy = oy - ay, tvz = oz - az;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      const bool in_u = ok && u >= 0.0f && u <= 1.0f;
      if (!__any_sync(FULL, in_u)) continue;
      // qvec = tvec x e1
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      const int id = __float_as_int(f[ID]);
      if (in_u && vv >= 0.0f && u + vv <= 1.0f && t > tmin &&
          t < best_t && id != excl) {
        best_t = t;
        best_id = id;
        best_u = u;
        best_v = vv;
      }
    }
  }
  if (live) {
    out_t[i] = best_t;
    out_prim[i] = best_id;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` without
// synchronising and returns cudaGetLastError() after the launch (0 = ok).
// tris, tris_t1, tris_t2: f32[rows, 16]; o, d: f32[n, 3]; t_min, t_max,
// time: f32[n]; exclude: i32[n]; outputs f32/i32/f32/f32 [n].
extern "C" int mt_closest_launch(
    const float* tris, const float* tris_t1, const float* tris_t2, int rows,
    int shadow, int motion, const float* o, const float* d,
    const float* t_min, const float* t_max, const int* exclude,
    const float* time, int n, float* out_t, int* out_prim, float* out_u,
    float* out_v, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vis_col = shadow ? 10 : 9;
  switch (motion) {
    case 0:
      mt_closest_kernel<0><<<grid, BLOCK, 0, s>>>(
          tris, tris_t1, tris_t2, rows, vis_col, o, d, t_min, t_max, exclude,
          time, n, out_t, out_prim, out_u, out_v);
      break;
    case 1:
      mt_closest_kernel<1><<<grid, BLOCK, 0, s>>>(
          tris, tris_t1, tris_t2, rows, vis_col, o, d, t_min, t_max, exclude,
          time, n, out_t, out_prim, out_u, out_v);
      break;
    case 2:
      mt_closest_kernel<2><<<grid, BLOCK, 0, s>>>(
          tris, tris_t1, tris_t2, rows, vis_col, o, d, t_min, t_max, exclude,
          time, n, out_t, out_prim, out_u, out_v);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
