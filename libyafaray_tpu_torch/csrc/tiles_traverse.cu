// Tile traversal of the block accelerator, written for Hopper (sm_90a).
//
// Replaces both TPU kernels behind libyafaray_tpu/accel/tiles.py
// tiles_traverse, for static scenes without instancing:
//   * _tile_kernel_resident (tiles.py:277), which keeps the whole block
//     table in VMEM, and
//   * _tile_kernel (tiles.py:123), which streams each candidate block's
//     slab from HBM with double-buffered DMA for tables above the 96 MiB
//     VMEM budget.
// The split between the two follows the TPU's VMEM size, not the
// algorithm; on Hopper one kernel stages every candidate slab through shared
// memory and serves tables of any size.
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
// What bounds it on an H100: about 45 flops (one IEEE division among them)
// per ray-triangle pair, against one 6 KB slab load per candidate block per
// tile (shared by 128 rays) and 64 + 16 bytes of ray state per ray. At the
// 203k-triangle terrain a tile tests a few dozen candidate blocks of 128
// triangles, so it is bound by arithmetic and issue (the exit test's block
// reduction and two barriers per sub-chunk are the overhead). The design:
//   * the ray lives in registers; the exit bound is a block-wide max by warp
//     shuffles and one shared-memory word per warp;
//   * each sub-chunk's 11 used rows (vertices, the visibility row, the prim
//     id: 5.5 KB) are staged in shared memory by all threads, one coalesced
//     row load per thread each, between two __syncthreads(); every thread
//     then reads the same triangle (a broadcast, free of bank conflicts).
//     A block of B = 1024 triangles is 8 sub-chunks; no dynamic shared
//     memory is needed at any B;
//   * the arithmetic is written in the Pallas kernel's order and the file is
//     built with --fmad=false, so every product and sum rounds on its own as
//     PyTorch's elementwise ops do: on the card the kernel agrees with its
//     plain PyTorch version (tile_walk_ref).
// cp.async / TMA double buffering of the slabs and wgmma are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RAY_TILE = 128;  // rays per tile = threads per block
constexpr int SUB = 128;       // triangles per staged sub-chunk
constexpr int UNROLL = 6;      // candidates between two exit tests
constexpr int NROW = 11;       // staged rows: 9 vertex rows, visibility, id
constexpr int RAY_COLS = 16;   // floats per packed ray
constexpr float EPS_DET = 1e-10f;

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

__global__ void __launch_bounds__(RAY_TILE) tiles_traverse_kernel(
    const float* __restrict__ rays, const int* __restrict__ cand,
    const float* __restrict__ ent, const int* __restrict__ count,
    const float* __restrict__ tab, int c_pad, int block_rows, int vis_col,
    int any_hit, int num_blocks, float* __restrict__ out_t,
    float* __restrict__ out_id, float* __restrict__ out_u,
    float* __restrict__ out_v) {
  __shared__ float s_tri[NROW][SUB];
  __shared__ float s_red[RAY_TILE / 32];

  const int tile = blockIdx.x;
  const int64_t ray = (int64_t)tile * RAY_TILE + threadIdx.x;
  const float* r = rays + ray * RAY_COLS;
  const float ox = r[0], oy = r[1], oz = r[2];
  const float dx = r[3], dy = r[4], dz = r[5];
  const float tmin = r[6], excl = r[8];
  float best_t = r[7], best_id = -1.0f, best_u = 0.0f, best_v = 0.0f;

  const int cnt = count[tile];
  const int* cand_t = cand + (int64_t)tile * c_pad;
  const float* ent_t = ent + (int64_t)tile * c_pad;
  const int n_sub = block_rows / SUB;
  // slab row of each staged row
  const int src_row[NROW] = {0, 1, 2, 3, 4, 5, 6, 7, 8, vis_col, 11};

  for (int c = 0;; c += UNROLL) {
    const float reach = (any_hit && best_id >= 0.0f) ? -INFINITY : best_t;
    const float bound = tile_max(reach, s_red);
    if (!(c < cnt && ent_t[min(c, c_pad - 1)] <= bound)) break;
    for (int k = 0; k < UNROLL && c + k < cnt; ++k) {
      const int blk = min(max(cand_t[c + k], 0), num_blocks - 1);
      const float* slab = tab + (int64_t)blk * 16 * block_rows;
      for (int s = 0; s < n_sub; ++s) {
        __syncthreads();  // every thread is done with the previous sub-chunk
#pragma unroll
        for (int q = 0; q < NROW; ++q)
          s_tri[q][threadIdx.x] =
              slab[(int64_t)src_row[q] * block_rows + s * SUB + threadIdx.x];
        __syncthreads();
        // lowest t among this sub-chunk's hits, lowest prim id at that t
        float tc = INFINITY, cid = INFINITY, cu = 0.0f, cv = 0.0f;
        for (int j = 0; j < SUB; ++j) {
          const float ax = s_tri[0][j], ay = s_tri[1][j], az = s_tri[2][j];
          const float e1x = s_tri[3][j] - ax, e1y = s_tri[4][j] - ay,
                      e1z = s_tri[5][j] - az;
          const float e2x = s_tri[6][j] - ax, e2y = s_tri[7][j] - ay,
                      e2z = s_tri[8][j] - az;
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
          const float pid = s_tri[10][j];
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
  out_t[ray] = best_t;
  out_id[ray] = best_id;
  out_u[ray] = best_u;
  out_v[ray] = best_v;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` without
// synchronising and returns cudaGetLastError() after the launch (0 = ok).
// rays: f32[num_tiles * 128, 16]; cand: i32[num_tiles, c_pad];
// ent: f32[num_tiles, c_pad]; count: i32[num_tiles];
// tab: f32[num_blocks, 16, block_rows] (block_rows a multiple of 128);
// outputs: f32[num_tiles * 128] each (t, prim id as a float, u, v).
extern "C" int tiles_traverse_launch(
    const float* rays, const int* cand, const float* ent, const int* count,
    const float* tab, int num_tiles, int c_pad, int block_rows, int vis_col,
    int any_hit, int num_blocks, float* out_t, float* out_id, float* out_u,
    float* out_v, void* stream) {
  if (num_tiles <= 0) return 0;
  if (block_rows <= 0 || block_rows % SUB != 0 || c_pad <= 0 ||
      num_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  tiles_traverse_kernel<<<num_tiles, RAY_TILE, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      rays, cand, ent, count, tab, c_pad, block_rows, vis_col, any_hit,
      num_blocks, out_t, out_id, out_u, out_v);
  return (int)cudaGetLastError();
}
