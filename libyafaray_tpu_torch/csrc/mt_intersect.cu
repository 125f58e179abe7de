// Möller-Trumbore closest hit of a wavefront of rays against a packed
// triangle table, written for Hopper (sm_90a).
//
// Replaces: libyafaray_tpu/accel/pallas_intersect.py::_mt_kernel (the Pallas
// TPU kernel behind mt_closest), which carries every closest-hit and shadow
// query of scenes with 1..16384 faces.
//
// What it computes, per ray: the lowest t in (t_min, t_max) over all table
// rows whose visibility column (9 = camera/bounce, 10 = shadow) is set and
// whose prim id differs from the ray's exclude id. On an exact t tie the
// lowest prim id wins, with u/v from that triangle. Output t is t_max and
// prim -1 on a miss. With MOTION = 1 the three vertices are blended per ray
// as c0*(1-tt) + c1*tt; with MOTION = 2 as the quadratic b-spline
// c0*(1-tt)^2 + c1*(2*tt*(1-tt)) + c2*tt^2.
//
// What bounds it on an H100: about 45 flops (one IEEE division among them)
// per ray-triangle pair against 44 bytes of ray state in and 16 bytes of
// hit record out per ray, so at the tables this path sees (64 rows for the
// Cornell box, up to 16384) it is bound by arithmetic and issue, not by
// device memory. The design keeps every operand of the inner loop on chip:
//   * one thread per ray, 128 threads per block, the ray in registers;
//   * the table is streamed through shared memory in chunks of CHUNK rows
//     (12 floats each: nine vertex coordinates, the selected visibility
//     column and the prim id), loaded cooperatively with __syncthreads()
//     around each chunk; all threads then read the same row (a broadcast,
//     free of bank conflicts). A 16384-row table (1 MiB) does not fit in
//     shared memory, hence the streaming;
//   * each thread scans the chunk in row order and accepts a hit only on a
//     strict t < best_t. Prim ids ascend with rows, so this reproduces the
//     Pallas kernel's tie-break (lowest id at equal t) without a reduction;
//   * the arithmetic is written in the Pallas kernel's order and the file is
//     built with --fmad=false, so every product and sum rounds on its own as
//     PyTorch's elementwise ops do: on the card the kernel agrees with its
//     plain PyTorch version (mt_closest_ref) bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;   // rays per block, one thread each
constexpr int CHUNK = 128;   // table rows staged in shared memory per step
constexpr int ROW = 16;      // floats per packed table row
constexpr float EPS_DET = 1e-10f;

template <int MOTION>
__global__ void __launch_bounds__(BLOCK) mt_closest_kernel(
    const float* __restrict__ tris, const float* __restrict__ tris_t1,
    const float* __restrict__ tris_t2, int rows, int vis_col,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    const int* __restrict__ exclude, const float* __restrict__ time, int n,
    float* __restrict__ out_t, int* __restrict__ out_prim,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  __shared__ float s_v0[CHUNK][9];
  __shared__ float s_v1[MOTION >= 1 ? CHUNK : 1][9];
  __shared__ float s_v2[MOTION == 2 ? CHUNK : 1][9];
  __shared__ float s_vis[CHUNK];
  __shared__ int s_id[CHUNK];

  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, best_t = -1.f, tt = 0.f;
  int excl = -1;
  if (live) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tmin = t_min[i];
    best_t = t_max[i];
    excl = exclude[i];
    if (MOTION) tt = time[i];
  }
  int best_id = -1;
  float best_u = 0.f, best_v = 0.f;
  // per-ray blend weights, in the Pallas kernel's order
  const float tc = 1.0f - tt;
  const float w0 = MOTION == 2 ? tc * tc : tc;
  const float w1 = MOTION == 2 ? (2.0f * tt) * tc : tt;
  const float w2 = tt * tt;

  for (int base = 0; base < rows; base += CHUNK) {
    const int cnt = min(CHUNK, rows - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int k = threadIdx.x; k < cnt * 9; k += BLOCK) {
      const int r = k / 9, c = k - r * 9;
      const int64_t src = (int64_t)(base + r) * ROW + c;
      s_v0[r][c] = tris[src];
      if (MOTION >= 1) s_v1[r][c] = tris_t1[src];
      if (MOTION == 2) s_v2[r][c] = tris_t2[src];
    }
    for (int r = threadIdx.x; r < cnt; r += BLOCK) {
      const int64_t row = (int64_t)(base + r) * ROW;
      s_vis[r] = tris[row + vis_col];
      s_id[r] = (int)tris[row + 11];
    }
    __syncthreads();
    if (!live) continue;
    for (int r = 0; r < cnt; ++r) {
      float v[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        if (MOTION == 2)
          v[c] = s_v0[r][c] * w0 + s_v1[r][c] * w1 + s_v2[r][c] * w2;
        else if (MOTION == 1)
          v[c] = s_v0[r][c] * w0 + s_v1[r][c] * w1;
        else
          v[c] = s_v0[r][c];
      }
      const float e1x = v[3] - v[0], e1y = v[4] - v[1], e1z = v[5] - v[2];
      const float e2x = v[6] - v[0], e2y = v[7] - v[1], e2z = v[8] - v[2];
      // pvec = d x e2
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const bool ok = fabsf(det) > EPS_DET;
      const float inv_det = (ok ? 1.0f : 0.0f) / (ok ? det : 1.0f);
      // tvec = o - v0
      const float tvx = ox - v[0], tvy = oy - v[1], tvz = oz - v[2];
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      // qvec = tvec x e1
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      const bool hit = ok && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f &&
                       t > tmin && t < best_t && s_vis[r] > 0.5f &&
                       s_id[r] != excl;
      if (hit) {
        best_t = t;
        best_id = s_id[r];
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
