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
// What it computes. One thread block per tile of RAY_TILE sorted rays. The
// tile walks its candidate list (cand, ent, count from tile_candidates)
// front to back. Before every group of UNROLL candidates the whole tile
// takes the exit test: a closest-hit tile goes on while c < count and
// ent[c] <= the largest best_t of its rays; an any-hit tile while c < count
// and ent[c] <= the largest best_t of its rays without a hit. Candidates of
// a group past the list's end are skipped. Each candidate block is
// intersected in sub-chunks of SUB triangles, exactly as the JAX package's
// _mt_update: within a sub-chunk the hit at the lowest t wins and among hits
// at that t the lowest prim id (prim ids in a block are in morton order, not
// ascending, so the first hit in lane order is not the answer); the best hit
// is replaced only on a strictly lower t. Hits need t in (t_min, best_t],
// the selected visibility row > 0.5 and prim id != the ray's exclude id
// (both compared as floats, as in the table). Padding lanes carry
// visibility 0 and prim id -2; dead rays (t_max < t_min) and the padded
// tail rays can never hit and cannot raise the exit bound.
//
// The cover-order any hit (the JAX package's opt-in YAF_COVER_ORDER=1,
// tiles.py:158-161 and :300-306) walks lists that tile_candidates(any_hit)
// sorted by descending ray coverage; `ent` then holds minus the coverage,
// not a distance, and is never read. Its exit test is a block-wide vote: the
// tile goes on while c < count and some ray is unhit with t_max >= t_min
// (its own t-range was already applied by candidate membership).
//
// The arms are compile-time specialisations (template MOTION x INST x
// COVER; COVER only with any hit):
//   * MOTION 1 / 2 (tab_t1, and tab_t2 for the quadratic b-spline): the
//     keyframes' 9 vertex rows are staged beside the 11 rows of tab, and
//     every ray blends each triangle with its own weights,
//     row = v*w0 + t1*w1 [+ t2*w2], with (w0, w1, w2) = (1-t, t, t) or
//     ((1-t)^2, 2t(1-t), t^2) for the time t in ray column 9;
//   * INST (blk_base, blk_minv, id_delta, inv_rows): a candidate j is a
//     virtual block. Its three scalars are uniform across the thread block;
//     the slab comes from the physical row blk_base[j]; when blk_minv[j] > 0
//     every ray is transformed object<-world by the 12 floats of
//     inv_rows[blk_minv[j]] (broadcast loads), m0*ox + m1*oy + m2*oz + m3
//     left to right; id_delta[j] is added to the prim id, as a float, before
//     the exclude test and the tie-break.
//
// What bounds it on an H100. About 45 flops per ray-triangle pair (72 with
// the linear blend, 90 with the quadratic one, plus 33 per candidate for an
// instance's ray transform) against one 5.5 KB slab sub-chunk (10 / 14.5 KB
// with motion) per 128 x 128 pairs: far above the card's ratio of flops to
// bytes, so it is bound by the instructions it issues per pair (about 100
// SASS instructions in the static arm, with every product and sum rounded
// on its own) and by how many warps walk each tile: a tile's candidates are
// walked in order, and the incoherent wavefronts (bounces, the background
// light's shadow rays) have few tiles with candidates (660 and 1,317 of
// 4,050 in the forest's) and long lists. The design:
//   * S = 8 threads a ray, 1,024 a block (32 warps a tile): thread part of
//     a ray tests triangles part, part + 8, ... of each sub-chunk, and the
//     eight (t, prim id) minima are merged by three shuffle rounds before
//     the best hit is updated. Two and four rays a thread (sharing each
//     triangle's loads and edges) were measured and lost: their registers
//     cut the resident warps, and each tile had fewer warps;
//   * the pair loop has a constant trip count (SUB / S) and is unrolled;
//   * the reciprocal 1/det is __frcp_rn, IEEE round to nearest, in place of
//     a division whose numerator is not the constant 1 (the full div.rn
//     sequence); for a non-degenerate det it is the same correctly rounded
//     value, and 0 where |det| <= EPS_DET as 0/1 was;
//   * the slabs are staged double-buffered with cp.async (16 bytes a
//     thread; a warp copies one 512-byte row): the next sub-chunk, which may
//     be the next candidate's first, is in flight while the current one is
//     intersected, and one barrier per sub-chunk both publishes the current
//     buffer and frees the other one. A copy issued past the group's exit
//     test is discarded. The bulk copy (cp.async.bulk, one lane per row,
//     completion on an mbarrier) was measured beside it and was no faster:
//     the copies are a few instructions a thread against hundreds of pair
//     instructions per sub-chunk, and cp.async needs no mbarrier;
//   * a warp whose rays have nothing left to find skips a sub-chunk's pair
//     tests (one warp-uniform __all_sync per sub-chunk): each of its 4 rays
//     is dead (no t lies in (t_min, best_t]), or, for an any-hit query, dead
//     or already hit. It still takes part in the copies and the barriers;
//   * the ray state lives in registers; the exit bound is a block-wide max
//     by warp shuffles and one shared-memory word per warp.
// Why the results are the same bits as the plain version (tile_walk_ref):
// the walk's rule is untouched (the same candidates in the same order, the
// exit test every UNROLL candidates, the (t, prim id) tie-break), each ray's
// arithmetic is the Pallas kernel's, in its order, and the file is built
// with --fmad=false (and without -ftz or fast division), so every product
// and sum rounds on its own as PyTorch's elementwise ops do. The minimum
// over a ray's threads is the sub-chunk's whatever the split, as no two
// triangles of a block share a prim id. A skipped warp holds only rays that
// could not hit (closest hit: bit for bit unchanged) or any-hit rays that
// already have a hit: they stay hit, and the rays still unhit test every
// pair they did, so hit/miss and the exit test are unchanged. The t and
// prim id an any-hit ray reports may then come from an earlier triangle
// than the plain version's: for any hit only hit/miss is defined.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RAY_TILE = 128;  // rays per tile
constexpr int S = 8;           // threads sharing a ray's triangles
constexpr int NT = RAY_TILE * S;          // threads per block
constexpr int NW = NT / 32;               // warps per block
static_assert(32 % S == 0 && NT <= 1024, "a ray's threads share a warp");
constexpr int SUB = 128;       // triangles per staged sub-chunk
constexpr int UNROLL = 6;      // candidates between two exit tests
constexpr int NROW = 11;       // staged rows of tab: 9 vertex rows, vis, id
constexpr int NKEY = 9;        // staged rows of a keyframe: its vertices
constexpr int CHUNKS = SUB / 4;  // 16-byte copies per staged row
constexpr int RAY_COLS = 16;   // floats per packed ray
constexpr float EPS_DET = 1e-10f;
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Block-wide max of x.
__device__ __forceinline__ float tile_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  __syncthreads();  // every thread has read red[] of the previous test
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) m = fmaxf(m, red[w]);
  return m;
}

// Physical slab row of the tile's candidate ci.
template <bool INST>
__device__ __forceinline__ int slab_of(const WalkArgs& a, const int* cand_t,
                                       int ci) {
  const int jv = min(max(cand_t[ci], 0), a.num_blocks - 1);
  return INST ? min(max(a.blk_base[jv], 0), a.num_phys - 1) : jv;
}

// Start the copies of sub-chunk s of slab jp into dst: the 11 used rows of
// tab (9 vertex rows, the selected visibility row, the prim id row) and the
// keyframes' vertex rows. Warp-uniform rows, 16 bytes a thread.
template <int MOTION>
__device__ __forceinline__ void stage(float (*dst)[SUB], const WalkArgs& a,
                                      int jp, int s) {
  constexpr int NS = NROW + NKEY * MOTION;
  const int64_t at = (int64_t)jp * 16 * a.block_rows + (int64_t)s * SUB;
#pragma unroll
  for (int it = 0; it < (NS * CHUNKS + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (i < NS * CHUNKS) {
      const int q = i / CHUNKS, col = (i % CHUNKS) * 4;
      const float* src;
      if (q < NROW)
        src = a.tab + (int64_t)(q < 9 ? q : (q == 9 ? a.vis_col : 11)) *
                          a.block_rows;
      else if (q < NROW + NKEY)
        src = a.tab_t1 + (int64_t)(q - NROW) * a.block_rows;
      else
        src = a.tab_t2 + (int64_t)(q - NROW - NKEY) * a.block_rows;
      cp_async16(&dst[q][col], src + at + col);
    }
  }
}

template <int MOTION, bool INST, bool COVER>
__global__ void __launch_bounds__(NT)
    tiles_traverse_kernel(const WalkArgs a) {
  constexpr int NS = NROW + NKEY * MOTION;
  __shared__ __align__(16) float s_tri[2][NS][SUB];
  __shared__ float s_red[NW];

  const int tile = blockIdx.x;
  // S neighbouring lanes share a ray; the part-th of them tests the
  // triangles j = part, part + S, ... of each sub-chunk
  const int part = threadIdx.x % S;
  const int64_t ray = (int64_t)tile * RAY_TILE + threadIdx.x / S;
  const float* r = a.rays + ray * RAY_COLS;
  const float wox = r[0], woy = r[1], woz = r[2];
  const float wdx = r[3], wdy = r[4], wdz = r[5];
  const float tmin = r[6], tmax = r[7], excl = r[8];
  float best_t = tmax, best_id = -1.0f, best_u = 0.0f, best_v = 0.0f;
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
  const int n_sub = a.block_rows / SUB;
  int buf = 0;
  if (cnt > 0) stage<MOTION>(s_tri[0], a, slab_of<INST>(a, cand_t, 0), 0);

  for (int c = 0;; c += UNROLL) {
    if (COVER) {
      // some ray of the tile still unhit with a live t-range (one vote per
      // ray, from its first thread)
      const bool unhit = part == 0 && best_id < 0.0f && tmax >= tmin;
      if (!__syncthreads_or(unhit) || c >= cnt) break;
    } else {
      const float reach =
          (a.any_hit && best_id >= 0.0f) ? -INFINITY : best_t;
      const float bound = tile_max(reach, s_red);
      if (!(c < cnt && ent_t[min(c, a.c_pad - 1)] <= bound)) break;
    }
    for (int k = 0; k < UNROLL && c + k < cnt; ++k) {
      const int ci = c + k;
      const int jv = min(max(cand_t[ci], 0), a.num_blocks - 1);
      const int jp = slab_of<INST>(a, cand_t, ci);
      float ox = wox, oy = woy, oz = woz, dx = wdx, dy = wdy, dz = wdz;
      float delta = 0.0f;
      if (INST) {
        // uniform across the thread block: one candidate for all its rays
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
      for (int s = 0; s < n_sub; ++s, buf ^= 1) {
        // this thread's copies of the current sub-chunk have landed; after
        // the barrier every thread's have, and no thread reads the other
        // buffer any more
        cp_async_wait_all();
        __syncthreads();
        if (s + 1 < n_sub)
          stage<MOTION>(s_tri[buf ^ 1], a, jp, s + 1);
        else if (ci + 1 < cnt)
          stage<MOTION>(s_tri[buf ^ 1], a, slab_of<INST>(a, cand_t, ci + 1),
                        0);
        // a warp whose rays have nothing left to find
        if (__all_sync(FULL, !(best_t > tmin) ||
                                 (a.any_hit && best_id >= 0.0f)))
          continue;
        const float(*sb)[SUB] = s_tri[buf];
        // lowest t among this thread's hits in the sub-chunk, lowest prim id
        // at that t
        float tc = INFINITY, cid = INFINITY, cu = 0.0f, cv = 0.0f;
#pragma unroll
        for (int jj = 0; jj < SUB / S; ++jj) {
          const int j = part + jj * S;
          float vt[NKEY];
#pragma unroll
          for (int q = 0; q < NKEY; ++q) {
            float x = sb[q][j];
            if (MOTION >= 1) x = x * w0 + sb[NROW + q][j] * w1;
            if (MOTION == 2) x = x + sb[NROW + NKEY + q][j] * w2;
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
          const float inv_det = ok ? __frcp_rn(det) : 0.0f;
          // tvec = o - v0
          const float tvx = ox - ax, tvy = oy - ay, tvz = oz - az;
          const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
          // qvec = tvec x e1
          const float qvx = tvy * e1z - tvz * e1y;
          const float qvy = tvz * e1x - tvx * e1z;
          const float qvz = tvx * e1y - tvy * e1x;
          const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
          const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
          float pid = sb[10][j];
          if (INST) pid = pid + delta;
          const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                           t > tmin && t <= best_t && sb[9][j] > 0.5f &&
                           pid != excl;
          if (hit && (t < tc || (t == tc && pid < cid))) {
            tc = t;
            cid = pid;
            cu = u;
            cv = v;
          }
        }
        // the lowest (t, prim id) over the ray's S threads: the same hit
        // whatever the split, as no two triangles of a block share an id
#pragma unroll
        for (int off = 1; off < S; off <<= 1) {
          const float t2 = __shfl_xor_sync(FULL, tc, off);
          const float id2 = __shfl_xor_sync(FULL, cid, off);
          const float u2 = __shfl_xor_sync(FULL, cu, off);
          const float v2 = __shfl_xor_sync(FULL, cv, off);
          const bool take = (t2 < tc) | ((t2 == tc) & (id2 < cid));
          tc = take ? t2 : tc;
          cid = take ? id2 : cid;
          cu = take ? u2 : cu;
          cv = take ? v2 : cv;
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
  cp_async_wait_all();  // a copy issued past the exit test lands unread
  if (part == 0) {
    a.out_t[ray] = best_t;
    a.out_id[ray] = best_id;
    a.out_u[ray] = best_u;
    a.out_v[ray] = best_v;
  }
}

template <int MOTION, bool INST, bool COVER>
int launch_arm(const WalkArgs& a, int num_tiles, cudaStream_t stream) {
  tiles_traverse_kernel<MOTION, INST, COVER>
      <<<num_tiles, NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool COVER>
int launch_cover(const WalkArgs& a, int motion, bool inst, int num_tiles,
                 cudaStream_t st) {
  switch (motion * 2 + (inst ? 1 : 0)) {
    case 0: return launch_arm<0, false, COVER>(a, num_tiles, st);
    case 1: return launch_arm<0, true, COVER>(a, num_tiles, st);
    case 2: return launch_arm<1, false, COVER>(a, num_tiles, st);
    case 3: return launch_arm<1, true, COVER>(a, num_tiles, st);
    case 4: return launch_arm<2, false, COVER>(a, num_tiles, st);
    default: return launch_arm<2, true, COVER>(a, num_tiles, st);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` without
// synchronising and returns cudaGetLastError() after the launch (0 = ok).
// rays: f32[num_tiles * 128, 16] (column 9 the shutter time); cand:
// i32[num_tiles, c_pad]; ent: f32[num_tiles, c_pad]; count: i32[num_tiles];
// tab, tab_t1, tab_t2: f32[num_phys, 16, block_rows], 16-byte aligned
// (block_rows a multiple of 128; tab_t1 for motion >= 1, tab_t2 for motion
// 2, else NULL); blk_base, blk_minv, id_delta: i32[num_blocks] and
// inv_rows: f32[num_inv, 12] for instanced tables, else all NULL (and
// candidate ids index tab directly); cover: 1 for the cover-order walk
// (any_hit must be 1; lists from tile_candidates(any_hit)); outputs:
// f32[num_tiles * 128] each (t, prim id as a float, u, v).
extern "C" int tiles_traverse_launch(
    const float* rays, const int* cand, const float* ent, const int* count,
    const float* tab, const float* tab_t1, const float* tab_t2,
    const int* blk_base, const int* blk_minv, const int* id_delta,
    const float* inv_rows, int num_tiles, int c_pad, int block_rows,
    int vis_col, int any_hit, int cover, int motion, int num_blocks,
    int num_phys, int num_inv, float* out_t, float* out_id, float* out_u,
    float* out_v, void* stream) {
  if (num_tiles <= 0) return 0;
  const bool inst = blk_base != nullptr;
  const uintptr_t align = reinterpret_cast<uintptr_t>(tab) |
                          reinterpret_cast<uintptr_t>(tab_t1) |
                          reinterpret_cast<uintptr_t>(tab_t2);
  if (block_rows <= 0 || block_rows % SUB != 0 || c_pad <= 0 ||
      num_blocks <= 0 || num_phys <= 0 || motion < 0 || motion > 2 ||
      (align & 15) != 0 || (motion >= 1 && tab_t1 == nullptr) ||
      (motion == 2 && tab_t2 == nullptr) || (cover && !any_hit) ||
      (inst && (blk_minv == nullptr || id_delta == nullptr ||
                inv_rows == nullptr || num_inv <= 0)))
    return (int)cudaErrorInvalidValue;
  const WalkArgs a{rays,     cand,     ent,      count,     tab,
                   tab_t1,   tab_t2,   blk_base, blk_minv,  id_delta,
                   inv_rows, c_pad,    block_rows, vis_col, any_hit,
                   num_blocks, num_phys, num_inv, out_t,    out_id,
                   out_u,    out_v};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cover ? launch_cover<true>(a, motion, inst, num_tiles, st)
               : launch_cover<false>(a, motion, inst, num_tiles, st);
}
