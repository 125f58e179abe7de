// Tile traversal of the block accelerator, written for Hopper (sm_90a).
//
// Replaces both TPU kernels behind libyafaray_tpu/accel/tiles.py
// tiles_traverse, with their static, motion-blur and instancing arms:
//   * _tile_kernel_resident (tiles.py:277), which keeps the whole block
//     table in VMEM, and
//   * _tile_kernel (tiles.py:123), which streams each candidate block's
//     slab from HBM with double-buffered DMA for tables above the 96 MiB
//     VMEM budget.
// The split between the two follows the TPU's VMEM size, not the
// algorithm; on Hopper one kernel stages every candidate slab through shared
// memory and serves tables of any size, motion blur included.
//
// What it computes. One block of RAY_TILE threads per tile of sorted rays,
// one thread per ray. The tile walks its candidate list (cand, ent, count
// from tile_candidates) front to back. Before every group of UNROLL
// candidates the whole tile takes the exit test: a closest-hit tile goes on
// while c < count and ent[c] <= the largest best_t of its rays; an any-hit
// tile while c < count and ent[c] <= the largest best_t of its rays without
// a hit. Candidates of a group past the list's end are skipped. Each
// candidate block is intersected in sub-chunks of SUB triangles, exactly as
// the JAX package's _mt_update: within a sub-chunk the hit at the lowest t
// wins and among hits at that t the lowest prim id (prim ids in a block are
// in morton order, not ascending, so the first hit in lane order is not the
// answer); the best hit is replaced only on a strictly lower t. Hits need
// t in (t_min, best_t], the selected visibility row > 0.5 and prim id !=
// the ray's exclude id (both compared as floats, as in the table). Padding
// lanes carry visibility 0 and prim id -2; dead rays (t_max < t_min) and
// the padded tail rays can never hit and cannot raise the exit bound.
//
// The arms are compile-time specialisations (template MOTION x INST), so
// the static arm's code is the one it always was:
//   * MOTION 1 / 2 (tab_t1, and tab_t2 for the quadratic b-spline): the
//     keyframes' 9 vertex rows are staged beside the 11 rows of tab, and
//     every thread blends each triangle with its own ray's weights,
//     row = v*w0 + t1*w1 [+ t2*w2], with (w0, w1, w2) = (1-t, t, t) or
//     ((1-t)^2, 2t(1-t), t^2) for the time t in ray column 9;
//   * INST (blk_base, blk_minv, id_delta, inv_rows): a candidate j is a
//     virtual block. Its three scalars are uniform across the thread block;
//     the slab comes from the physical row blk_base[j]; when blk_minv[j] > 0
//     every thread transforms its ray object<-world by the 12 floats of
//     inv_rows[blk_minv[j]] (broadcast loads), m0*ox + m1*oy + m2*oz + m3
//     left to right; id_delta[j] is added to the prim id, as a float, before
//     the exclude test and the tie-break.
//
// What bounds it on an H100: about 45 flops (one IEEE division among them)
// per ray-triangle pair, 72 with the linear blend (9 rows x 3 flops more),
// 90 with the quadratic one, plus 33 flops per candidate for an instance's
// ray transform; against one 6 KB slab load (8.5 KB / 11 KB with motion)
// per candidate block per tile (shared by 128 rays) and 64 + 16 bytes of
// ray state per ray. A tile tests a few dozen candidate blocks of 128
// triangles, so it is bound by arithmetic and issue (the exit test's block
// reduction and two barriers per sub-chunk are the overhead). The design:
//   * the ray lives in registers; the exit bound is a block-wide max by warp
//     shuffles and one shared-memory word per warp;
//   * each sub-chunk's used rows (11 of tab, 9 per keyframe: at most 29 rows,
//     14.8 KB of static shared memory) are staged by all threads, one
//     coalesced row load per thread each, between two __syncthreads(); every
//     thread then reads the same triangle (a broadcast, free of bank
//     conflicts). A block of B = 1024 triangles is 8 sub-chunks; no dynamic
//     shared memory is needed at any B;
//   * the arithmetic is written in the Pallas kernel's order and the file is
//     built with --fmad=false, so every product and sum rounds on its own as
//     PyTorch's elementwise ops do: on the card the kernel agrees with its
//     plain PyTorch version (tile_walk_ref).
// cp.async / TMA double buffering of the slabs and fused multiply-adds are
// later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RAY_TILE = 128;  // rays per tile = threads per block
constexpr int SUB = 128;       // triangles per staged sub-chunk
constexpr int UNROLL = 6;      // candidates between two exit tests
constexpr int NROW = 11;       // staged rows of tab: 9 vertex rows, vis, id
constexpr int NKEY = 9;        // staged rows of a keyframe: its vertices
constexpr int RAY_COLS = 16;   // floats per packed ray
constexpr float EPS_DET = 1e-10f;

struct WalkArgs {
  const float* rays;
  const int* cand;
  const float* ent;
  const int* count;
  const float* tab;
  const float* tab_t1;
  const float* tab_t2;
  const int* blk_base;
  const int* blk_minv;
  const int* id_delta;
  const float* inv_rows;
  int c_pad, block_rows, vis_col, any_hit;
  int num_blocks;  // candidate ids lie in [0, num_blocks)
  int num_phys;    // rows of tab
  int num_inv;     // rows of inv_rows
  float* out_t;
  float* out_id;
  float* out_u;
  float* out_v;
};

__device__ __forceinline__ float tile_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();  // every thread has read red[] of the previous test
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < RAY_TILE / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

template <int MOTION, bool INST>
__global__ void __launch_bounds__(RAY_TILE)
    tiles_traverse_kernel(const WalkArgs a) {
  __shared__ float s_tri[NROW + NKEY * MOTION][SUB];
  __shared__ float s_red[RAY_TILE / 32];

  const int tile = blockIdx.x;
  const int64_t ray = (int64_t)tile * RAY_TILE + threadIdx.x;
  const float* r = a.rays + ray * RAY_COLS;
  const float wox = r[0], woy = r[1], woz = r[2];
  const float wdx = r[3], wdy = r[4], wdz = r[5];
  const float tmin = r[6], excl = r[8];
  float best_t = r[7], best_id = -1.0f, best_u = 0.0f, best_v = 0.0f;
  // keyframe weights of this ray's shutter time
  float w0 = 1.0f, w1 = 0.0f, w2 = 0.0f;
  if (MOTION == 1) {
    const float tt = r[9];
    w0 = 1.0f - tt;
    w1 = tt;
  } else if (MOTION == 2) {
    const float tt = r[9];
    const float tc = 1.0f - tt;
    w0 = tc * tc;
    w1 = 2.0f * tt * tc;
    w2 = tt * tt;
  }

  const int cnt = a.count[tile];
  const int* cand_t = a.cand + (int64_t)tile * a.c_pad;
  const float* ent_t = a.ent + (int64_t)tile * a.c_pad;
  const int block_rows = a.block_rows;
  const int n_sub = block_rows / SUB;
  // slab row of each staged row of tab
  const int src_row[NROW] = {0, 1, 2, 3, 4, 5, 6, 7, 8, a.vis_col, 11};

  for (int c = 0;; c += UNROLL) {
    const float reach = (a.any_hit && best_id >= 0.0f) ? -INFINITY : best_t;
    const float bound = tile_max(reach, s_red);
    if (!(c < cnt && ent_t[min(c, a.c_pad - 1)] <= bound)) break;
    for (int k = 0; k < UNROLL && c + k < cnt; ++k) {
      const int jv = min(max(cand_t[c + k], 0), a.num_blocks - 1);
      int jp = jv;
      float ox = wox, oy = woy, oz = woz, dx = wdx, dy = wdy, dz = wdz;
      float delta = 0.0f;
      if (INST) {
        // uniform across the thread block: one candidate for all its rays
        jp = min(max(a.blk_base[jv], 0), a.num_phys - 1);
        const int mi = min(max(a.blk_minv[jv], 0), a.num_inv - 1);
        delta = (float)a.id_delta[jv];
        if (mi > 0) {  // row 0 is the identity: static blocks skip it
          const float* m = a.inv_rows + (int64_t)mi * 12;
          ox = m[0] * wox + m[1] * woy + m[2] * woz + m[3];
          oy = m[4] * wox + m[5] * woy + m[6] * woz + m[7];
          oz = m[8] * wox + m[9] * woy + m[10] * woz + m[11];
          dx = m[0] * wdx + m[1] * wdy + m[2] * wdz;
          dy = m[4] * wdx + m[5] * wdy + m[6] * wdz;
          dz = m[8] * wdx + m[9] * wdy + m[10] * wdz;
        }
      }
      const int64_t slab_at = (int64_t)jp * 16 * block_rows;
      const float* slab = a.tab + slab_at;
      for (int s = 0; s < n_sub; ++s) {
        const int lane = s * SUB + threadIdx.x;
        __syncthreads();  // every thread is done with the previous sub-chunk
#pragma unroll
        for (int q = 0; q < NROW; ++q)
          s_tri[q][threadIdx.x] = slab[(int64_t)src_row[q] * block_rows + lane];
        if (MOTION >= 1) {
#pragma unroll
          for (int q = 0; q < NKEY; ++q)
            s_tri[NROW + q][threadIdx.x] =
                a.tab_t1[slab_at + (int64_t)q * block_rows + lane];
        }
        if (MOTION == 2) {
#pragma unroll
          for (int q = 0; q < NKEY; ++q)
            s_tri[NROW + NKEY + q][threadIdx.x] =
                a.tab_t2[slab_at + (int64_t)q * block_rows + lane];
        }
        __syncthreads();
        // lowest t among this sub-chunk's hits, lowest prim id at that t
        float tc = INFINITY, cid = INFINITY, cu = 0.0f, cv = 0.0f;
        for (int j = 0; j < SUB; ++j) {
          float vt[NKEY];
#pragma unroll
          for (int q = 0; q < NKEY; ++q) {
            float x = s_tri[q][j];
            if (MOTION >= 1) x = x * w0 + s_tri[NROW + q][j] * w1;
            if (MOTION == 2) x = x + s_tri[NROW + NKEY + q][j] * w2;
            vt[q] = x;
          }
          const float ax = vt[0], ay = vt[1], az = vt[2];
          const float e1x = vt[3] - ax, e1y = vt[4] - ay, e1z = vt[5] - az;
          const float e2x = vt[6] - ax, e2y = vt[7] - ay, e2z = vt[8] - az;
          // pvec = d x e2
          const float pvx = dy * e2z - dz * e2y;
          const float pvy = dz * e2x - dx * e2z;
          const float pvz = dx * e2y - dy * e2x;
          const float det = e1x * pvx + e1y * pvy + e1z * pvz;
          const bool ok = fabsf(det) > EPS_DET;
          const float inv_det = (ok ? 1.0f : 0.0f) / (ok ? det : 1.0f);
          // tvec = o - v0
          const float tvx = ox - ax, tvy = oy - ay, tvz = oz - az;
          const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
          // qvec = tvec x e1
          const float qvx = tvy * e1z - tvz * e1y;
          const float qvy = tvz * e1x - tvx * e1z;
          const float qvz = tvx * e1y - tvy * e1x;
          const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
          const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
          float pid = s_tri[10][j];
          if (INST) pid = pid + delta;
          const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                           t > tmin && t <= best_t && s_tri[9][j] > 0.5f &&
                           pid != excl;
          if (hit && (t < tc || (t == tc && pid < cid))) {
            tc = t;
            cid = pid;
            cu = u;
            cv = v;
          }
        }
        if (tc < best_t) {
          best_t = tc;
          best_id = cid;
          best_u = cu;
          best_v = cv;
        }
      }
    }
  }
  a.out_t[ray] = best_t;
  a.out_id[ray] = best_id;
  a.out_u[ray] = best_u;
  a.out_v[ray] = best_v;
}

template <int MOTION, bool INST>
int launch_arm(const WalkArgs& a, int num_tiles, cudaStream_t stream) {
  tiles_traverse_kernel<MOTION, INST><<<num_tiles, RAY_TILE, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` without
// synchronising and returns cudaGetLastError() after the launch (0 = ok).
// rays: f32[num_tiles * 128, 16] (column 9 the shutter time); cand:
// i32[num_tiles, c_pad]; ent: f32[num_tiles, c_pad]; count: i32[num_tiles];
// tab, tab_t1, tab_t2: f32[num_phys, 16, block_rows] (block_rows a multiple
// of 128; tab_t1 for motion >= 1, tab_t2 for motion 2, else NULL);
// blk_base, blk_minv, id_delta: i32[num_blocks] and inv_rows:
// f32[num_inv, 12] for instanced tables, else all NULL (and candidate ids
// index tab directly); outputs: f32[num_tiles * 128] each (t, prim id as a
// float, u, v).
extern "C" int tiles_traverse_launch(
    const float* rays, const int* cand, const float* ent, const int* count,
    const float* tab, const float* tab_t1, const float* tab_t2,
    const int* blk_base, const int* blk_minv, const int* id_delta,
    const float* inv_rows, int num_tiles, int c_pad, int block_rows,
    int vis_col, int any_hit, int motion, int num_blocks, int num_phys,
    int num_inv, float* out_t, float* out_id, float* out_u, float* out_v,
    void* stream) {
  if (num_tiles <= 0) return 0;
  const bool inst = blk_base != nullptr;
  if (block_rows <= 0 || block_rows % SUB != 0 || c_pad <= 0 ||
      num_blocks <= 0 || num_phys <= 0 || motion < 0 || motion > 2 ||
      (motion >= 1 && tab_t1 == nullptr) ||
      (motion == 2 && tab_t2 == nullptr) ||
      (inst && (blk_minv == nullptr || id_delta == nullptr ||
                inv_rows == nullptr || num_inv <= 0)))
    return (int)cudaErrorInvalidValue;
  const WalkArgs a{rays,     cand,     ent,      count,     tab,
                   tab_t1,   tab_t2,   blk_base, blk_minv,  id_delta,
                   inv_rows, c_pad,    block_rows, vis_col, any_hit,
                   num_blocks, num_phys, num_inv, out_t,    out_id,
                   out_u,    out_v};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (motion * 2 + (inst ? 1 : 0)) {
    case 0: return launch_arm<0, false>(a, num_tiles, st);
    case 1: return launch_arm<0, true>(a, num_tiles, st);
    case 2: return launch_arm<1, false>(a, num_tiles, st);
    case 3: return launch_arm<1, true>(a, num_tiles, st);
    case 4: return launch_arm<2, false>(a, num_tiles, st);
    default: return launch_arm<2, true>(a, num_tiles, st);
  }
}
