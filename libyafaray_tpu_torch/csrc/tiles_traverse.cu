// Tile traversal of the block accelerator, written for Hopper (sm_90a):
// the walk (tiles_traverse_kernel, below) and the prepass that gives it
// its lists (tile_candidates_kernel, after it).
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

// ---------------------------------------------------------------------------
// The block prepass: every tile's candidate list (tiles.tile_candidates on
// a CUDA tensor, its default branch: one block a candidate, front to back or
// in cover order).
//
// Replaces no Pallas kernel: the JAX package computes the lists with XLA ops
// (libyafaray_tpu/accel/tiles.py tile_candidates), and the port's plain
// version (tile_candidates_ref) does the same in chunks of tiles, about 30
// elementwise launches a chunk over [g, 128, C] temporaries, one host read of
// which chunks are live and a sort of the whole [T, C] key matrix. Here one
// thread block of 128 threads makes one tile's list in one launch, and the
// host reads nothing.
//
// What it computes, as the plain version does. For ray r of the tile and
// block j, per axis ta = (bmin - o) * inv and tb = (bmax - o) * inv, with
// inv = 1 / d (|d| < 1e-12 replaced by +-1e-12, the sign of d, +0 counting
// as positive); tn = the max over the axes of min(ta, tb), tf = the min of
// max(ta, tb), with the NaN propagation of torch.minimum / torch.maximum;
// the ray enters the block when tn <= tf, tf >= t_min and tn <= t_max, at
// max(tn, t_min). A block's entry is the least over the tile's rays that
// enter it, and the block is a candidate when that entry is finite. The
// list holds the candidates sorted by entry (cover: by minus the number of
// rays that enter, `ent` then holding minus that count), ties in block
// order, then the other blocks in block order with `ent` inf, then block 0 /
// inf up to c_pad; count = the candidates. The chunk rule of the JAX
// package is kept: a tile gets no candidates only when every tile of its
// chunk of `chunk` tiles (computed by the wrapper as the plain version
// does) holds no ray with t_max >= t_min; a dead tile of a live chunk is
// tested like any other, and a dead ray whose slab interval straddles its
// empty t-range still makes its blocks candidates.
//
// What bounds it on an H100. T * 128 * C pair tests (825M for a 720^2
// camera query over the terrain's 1,591 blocks), each about 30 fp32
// instructions with no multiply-add to fuse (6 subtractions, 6 products, 13
// min / max, 3 comparisons, the entry's min): bound by the instructions it
// issues, not by bytes (the lists are T * c_pad * 8 bytes, 54 MB a query).
// The design:
//   * the tile's rays (origin, inverse direction, t-range: 32 bytes) are
//     staged once in shared memory, and every thread reads ray r as a
//     broadcast; each thread owns blocks j = tid, tid + 128, ... and tests
//     PK of them against each ray, their bounds and running entry minima in
//     registers, so no reduction across threads is needed for a block;
//   * the candidates of each page of 128 * PK blocks are compacted in block
//     order by warp ballots and one shared-memory word a warp, as 64-bit
//     entries (the key's order-preserving bits, then the block index): the
//     pair (key, block) is unique, so any sort by it is the stable sort by
//     key. The tail's position of block j is count + j - (candidates
//     before j), found by a binary search of the compacted list;
//   * the list is sorted in shared memory by a bitonic network over the next
//     power of two above count (62 candidates a live tile on the terrain's
//     camera query). The shared list holds up to SORT_CAP entries; above
//     that number of blocks (the instanced scenes' virtual blocks can pass
//     it) the list goes to a global scratch row, runs of SORT_CAP are sorted
//     in shared memory, and each entry's final place is its rank in its own
//     run plus the entries below it in the other runs (binary searches);
//   * a tile of a dead chunk writes the identity list and stops, after
//     reading at most its chunk's t-ranges.
// Why the lists are the same bits as the plain version's: the arithmetic is
// the same operations in the same order, built with --fmad=false (a product
// then a difference never fuses) and without -ftz; 1 / d is __frcp_rn, the
// correctly rounded reciprocal that torch's division gives; min.NaN /
// max.NaN propagate NaN as torch.minimum / torch.maximum do, and the entry's
// min and max see no NaN; the sort keys map -0 to +0, as the plain sort
// compares them equal. (An entry of -0 may come back as +0.)

namespace {

constexpr int PT = RAY_TILE;    // threads a tile: one a ray when staging
constexpr int PW = PT / 32;     // warps a tile
constexpr int PK = 4;           // blocks a thread tests against each ray
constexpr int SORT_CAP = 4096;  // entries a tile sorts in shared memory
constexpr unsigned long long NO_ENTRY = ~0ull;

struct CandArgs {
  const float* bmin;  // [num_blocks, 3]
  const float* bmax;
  const float* o;     // ray r's origin component k at o[r * o_s0 + k * o_s1]
  const float* d;
  const float* t_min;  // ray r's at t_min[r * tmin_s]
  const float* t_max;
  long long o_s0, o_s1, d_s0, d_s1, tmin_s, tmax_s;
  int num_tiles, num_blocks, c_pad, chunk;
  int* cand;                     // [num_tiles, c_pad]
  float* ent;                    // [num_tiles, c_pad]
  int* count;                    // [num_tiles]
  unsigned long long* scratch;   // [num_tiles, num_blocks] above SORT_CAP
};

struct __align__(16) PRay {
  float ox, oy, oz, t0, ix, iy, iz, t1;
};

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 1 / d with |d| < 1e-12 replaced by +-1e-12
__device__ __forceinline__ float safe_inv(float x) {
  return __frcp_rn(fabsf(x) < 1e-12f ? (x < 0.0f ? -1e-12f : 1e-12f) : x);
}

// Bits of a key whose unsigned order is the float order (-0 taken as +0),
// and back.
__device__ __forceinline__ unsigned key_bits(float x) {
  const unsigned u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__host__ __device__ __forceinline__ int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return x <= 0 ? 0 : p;
}

// The entry minima (and with COVER the ray counts) of this thread's blocks
// base + k * PT + tid, k < K, over the tile's rays.
template <int K, bool COVER>
__device__ __forceinline__ void test_blocks(const CandArgs& a,
                                            const PRay* s_ray, int base,
                                            float (&emin)[K], int (&cov)[K]) {
  float lx[K], ly[K], lz[K], hx[K], hy[K], hz[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = min(base + k * PT + (int)threadIdx.x, a.num_blocks - 1);
    lx[k] = a.bmin[3 * j];
    ly[k] = a.bmin[3 * j + 1];
    lz[k] = a.bmin[3 * j + 2];
    hx[k] = a.bmax[3 * j];
    hy[k] = a.bmax[3 * j + 1];
    hz[k] = a.bmax[3 * j + 2];
    emin[k] = INFINITY;
    cov[k] = 0;
  }
  const float4* rays = reinterpret_cast<const float4*>(s_ray);
#pragma unroll 2
  for (int r = 0; r < PT; ++r) {
    const float4 p = rays[2 * r];      // ox, oy, oz, t0
    const float4 q = rays[2 * r + 1];  // ix, iy, iz, t1
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float ta = (lx[k] - p.x) * q.x, tb = (hx[k] - p.x) * q.x;
      float tn = min_nan(ta, tb), tf = max_nan(ta, tb);
      ta = (ly[k] - p.y) * q.y;
      tb = (hy[k] - p.y) * q.y;
      tn = max_nan(tn, min_nan(ta, tb));
      tf = min_nan(tf, max_nan(ta, tb));
      ta = (lz[k] - p.z) * q.z;
      tb = (hz[k] - p.z) * q.z;
      tn = max_nan(tn, min_nan(ta, tb));
      tf = min_nan(tf, max_nan(ta, tb));
      const bool ok = (tn <= tf) & (tf >= p.w) & (tn <= q.w);
      if (ok) emin[k] = fminf(emin[k], fmaxf(tn, p.w));
      if (COVER) cov[k] += ok ? 1 : 0;
    }
  }
}

// One page of K * PT blocks from `base`: test them and append the
// candidates to list[n...] in block order; n grows by their number.
template <int K, bool COVER>
__device__ __forceinline__ void page(const CandArgs& a, const PRay* s_ray,
                                     int (*wc)[PW], unsigned long long* list,
                                     int base, int& n) {
  float emin[K];
  int cov[K];
  test_blocks<K, COVER>(a, s_ray, base, emin, cov);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ball[K];
  bool flag[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    flag[k] = base + k * PT + (int)threadIdx.x < a.num_blocks &&
              fabsf(emin[k]) < INFINITY;  // finite (never NaN)
    ball[k] = __ballot_sync(FULL, flag[k]);
    if (lane == 0) wc[k][warp] = __popc(ball[k]);
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int total = 0, before = 0;
#pragma unroll
    for (int w = 0; w < PW; ++w) {
      const int c = wc[k][w];
      total += c;
      before += w < warp ? c : 0;
    }
    if (flag[k]) {
      const float key = COVER ? -(float)cov[k] : emin[k];
      list[n + before + __popc(ball[k] & below)] =
          ((unsigned long long)key_bits(key) << 32) |
          (unsigned)(base + k * PT + (int)threadIdx.x);
    }
    n += total;
  }
}

// Sort s[0, P) ascending (P a power of two); ends with a barrier.
__device__ void bitonic_sort(unsigned long long* s, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P / 2; i += PT) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long x = s[lo], y = s[hi];
        if ((x > y) == ((lo & size) == 0)) {
          s[lo] = y;
          s[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ void put(int* cand_t, float* ent_t, int i,
                                    unsigned long long v) {
  cand_t[i] = (int)(unsigned)v;
  ent_t[i] = key_value((unsigned)(v >> 32));
}

template <bool COVER, bool BIG>
__global__ void __launch_bounds__(PT)
    tile_candidates_kernel(const CandArgs a) {
  extern __shared__ unsigned long long s_list[];  // pow2 >= C, or SORT_CAP
  __shared__ PRay s_ray[PT];
  __shared__ int s_wc[2][PK][PW];

  const int tile = blockIdx.x, tid = threadIdx.x, nb = a.num_blocks;
  int* cand_t = a.cand + (long long)tile * a.c_pad;
  float* ent_t = a.ent + (long long)tile * a.c_pad;

  // stage the tile's rays; one ray a thread
  bool live;
  {
    const long long r = (long long)tile * PT + tid;
    const float* o = a.o + r * a.o_s0;
    const float* d = a.d + r * a.d_s0;
    PRay p;
    p.ox = o[0];
    p.oy = o[a.o_s1];
    p.oz = o[2 * a.o_s1];
    p.ix = safe_inv(d[0]);
    p.iy = safe_inv(d[a.d_s1]);
    p.iz = safe_inv(d[2 * a.d_s1]);
    p.t0 = a.t_min[r * a.tmin_s];
    p.t1 = a.t_max[r * a.tmax_s];
    s_ray[tid] = p;
    live = p.t1 >= p.t0;
  }
  if (!__syncthreads_or(live)) {
    // a dead tile: its chunk is live if any of its tiles is
    const int c0 = tile / a.chunk * a.chunk;
    const int c1 = min(a.num_tiles, c0 + a.chunk);
    bool chunk_live = false;
    for (int u = c0; u < c1 && !chunk_live; ++u) {
      if (u == tile) continue;
      const long long r = (long long)u * PT + tid;
      chunk_live = __syncthreads_or(a.t_max[r * a.tmax_s] >=
                                    a.t_min[r * a.tmin_s]);
    }
    if (!chunk_live) {
      for (int j = tid; j < a.c_pad; j += PT) {
        cand_t[j] = j < nb ? j : 0;
        ent_t[j] = INFINITY;
      }
      if (tid == 0) a.count[tile] = 0;
      return;
    }
  }

  // the candidates, in block order
  unsigned long long* list = BIG ? a.scratch + (long long)tile * nb : s_list;
  int n = 0, buf = 0;
  for (int base = 0; base < nb; base += PK * PT, buf ^= 1) {
    switch (min(PK, (nb - base + PT - 1) / PT)) {
      case 4: page<4, COVER>(a, s_ray, s_wc[buf], list, base, n); break;
      case 3: page<3, COVER>(a, s_ray, s_wc[buf], list, base, n); break;
      case 2: page<2, COVER>(a, s_ray, s_wc[buf], list, base, n); break;
      default: page<1, COVER>(a, s_ray, s_wc[buf], list, base, n); break;
    }
  }
  __syncthreads();
  if (tid == 0) a.count[tile] = n;

  // the other blocks, in block order after the candidates: block j goes to
  // n + j - (the candidates before j)
  for (int j = tid; j < nb; j += PT) {
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((unsigned)list[mid] < (unsigned)j)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo < n && (unsigned)list[lo] == (unsigned)j) continue;
    cand_t[n + j - lo] = j;
    ent_t[n + j - lo] = INFINITY;
  }
  for (int i = nb + tid; i < a.c_pad; i += PT) {
    cand_t[i] = 0;
    ent_t[i] = INFINITY;
  }
  __syncthreads();  // the searches are done before the list is reordered

  if (!BIG || n <= SORT_CAP) {
    const int P = pow2_at_least(n);
    for (int i = tid; i < P; i += PT)
      s_list[i] = i < n ? (BIG ? list[i] : s_list[i]) : NO_ENTRY;
    __syncthreads();
    bitonic_sort(s_list, P);
    for (int i = tid; i < n; i += PT) put(cand_t, ent_t, i, s_list[i]);
    return;
  }
  // above the shared sort's capacity: sorted runs of SORT_CAP, then each
  // entry's rank across the runs
  const int runs = (n + SORT_CAP - 1) / SORT_CAP;
  for (int r = 0; r < runs; ++r) {
    const int r0 = r * SORT_CAP, len = min(SORT_CAP, n - r0);
    for (int i = tid; i < SORT_CAP; i += PT)
      s_list[i] = i < len ? list[r0 + i] : NO_ENTRY;
    __syncthreads();
    bitonic_sort(s_list, SORT_CAP);
    for (int i = tid; i < len; i += PT) list[r0 + i] = s_list[i];
    __syncthreads();
  }
  for (int i = tid; i < n; i += PT) {
    const unsigned long long v = list[i];
    const int own = i / SORT_CAP;
    int rank = i - own * SORT_CAP;
    for (int s = 0; s < runs; ++s) {
      if (s == own) continue;
      const int s0 = s * SORT_CAP;
      int lo = s0, hi = min(n, s0 + SORT_CAP);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (list[mid] < v)
          lo = mid + 1;
        else
          hi = mid;
      }
      rank += lo - s0;
    }
    put(cand_t, ent_t, rank, v);
  }
}

template <bool COVER, bool BIG>
int launch_candidates(const CandArgs& a, size_t smem, cudaStream_t st) {
  tile_candidates_kernel<COVER, BIG><<<a.num_tiles, PT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point of the prepass, loaded with ctypes. Launches on
// `stream` without synchronising and returns cudaGetLastError() after the
// launch (0 = ok). bmin, bmax: f32[num_blocks, 3], contiguous; ray r's
// origin and direction components k at o[r * o_s0 + k * o_s1] and
// d[r * d_s0 + k * d_s1], its t-range at t_min[r * tmin_s] and
// t_max[r * tmax_s] (strides in elements), for num_tiles * 128 rays;
// chunk: the tiles of the chunk rule; cover: 1 for cover order; outputs
// cand i32[num_tiles, c_pad], ent f32[num_tiles, c_pad], count
// i32[num_tiles]; scratch: u64[num_tiles, num_blocks] when num_blocks >
// tile_candidates_sort_cap(), else unused (may be NULL).
extern "C" int tile_candidates_launch(
    const float* bmin, const float* bmax, const float* o, const float* d,
    const float* t_min, const float* t_max, long long o_s0, long long o_s1,
    long long d_s0, long long d_s1, long long tmin_s, long long tmax_s,
    int num_tiles, int num_blocks, int c_pad, int chunk, int cover,
    int* cand, float* ent, int* count, unsigned long long* scratch,
    void* stream) {
  if (num_tiles <= 0) return 0;
  const bool big = num_blocks > SORT_CAP;
  if (num_blocks <= 0 || c_pad < num_blocks || chunk <= 0 ||
      (big && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const CandArgs a{bmin,   bmax,      o,          d,     t_min, t_max,
                   o_s0,   o_s1,      d_s0,       d_s1,  tmin_s, tmax_s,
                   num_tiles, num_blocks, c_pad, chunk, cand,  ent,
                   count,  scratch};
  const size_t smem = sizeof(unsigned long long) *
                      (big ? SORT_CAP : pow2_at_least(num_blocks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cover)
    return big ? launch_candidates<true, true>(a, smem, st)
               : launch_candidates<true, false>(a, smem, st);
  return big ? launch_candidates<false, true>(a, smem, st)
             : launch_candidates<false, false>(a, smem, st);
}

// The most blocks whose lists are sorted in shared memory alone.
extern "C" int tile_candidates_sort_cap() { return SORT_CAP; }
