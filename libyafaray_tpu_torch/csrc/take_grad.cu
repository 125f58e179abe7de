// The backward of `take` (ops/fast_grad.py): the reduction of every lane's
// incoming gradient onto the row of the small table that it gathered,
//
//     out[t, c] = sum_n (idx[n] == t) * g[n, c],   t < rows <= 4,096,
//
// written for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package writes this reduction as a
// one-hot product (libyafaray_tpu/ops/fast_grad.py) and leaves it to XLA's
// dot_general. The port's plain version, `onehot_grad`, builds that one-hot
// in device memory and multiplies it in f32, so that only one multiply-add
// in `rows` is useful; this kernel reads each lane once and never forms it.
//
// What bounds it on an H100. Each lane's index (8 bytes) and gradient row
// (4 * cols bytes) are read once, and the table (4 * cols bytes a row) is
// written once: lanes * 24 + rows * 16 bytes at 3.35 TB/s for the texel
// pool's rgba rows. The arithmetic is one add a lane and column. So it is
// bound by bytes, and at the main path's sizes (262,144 to 2,073,600 lanes,
// 6-41 MB, 2-12 us at the bound) by its launches as much.
//
// What its design does about it.
//   * Lanes are read once and coalesced: each block takes a contiguous
//     range of lanes, its warps take 32 neighbouring lanes at a time, UNROLL
//     rounds of loads in flight before the first is reduced. The ragged end
//     is masked here, so the caller pads nothing.
//   * No float atomics, and a fixed order of summation: each warp adds into
//     a private copy of the table (rows x cols floats of the block's shared
//     memory). Inside a round, __match_any_sync groups the lanes that hit
//     the same row (the no-hit lanes' shared texel, a wall's material), and
//     each group's sum is a pairwise tree over its lanes in lane order, by
//     pointer jumping over "the next lane of my group" with shuffles (at
//     most five steps); the group's first lane adds it to the warp's copy.
//     The block then sums its warps' copies in warp order into one partial
//     table; a second small kernel adds the partials in block order (each
//     output element's partials split over a fixed number of threads, then
//     a fixed shuffle tree), writing every element of the output. With one
//     block the first kernel writes the output itself. So the sums depend
//     only on the launch's layout, which depends only on the shape: two
//     calls on the same inputs give the same bits.
//   * The layout adapts to what it sees (ops/fast_grad.take_grad_layout):
//     the warps of a block to the table's bytes (at most 227 KB of copies
//     a block, 16 warps), the blocks to the lane count, at most one wave
//     of the card. A warp's rounds are bound by the latency of their
//     shuffles and loads, not by the bytes, so the most warps in flight
//     win. Columns are reduced COLS at a time (one grid row a group of
//     COLS columns), so any column count fits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int COLS = 4;       // most columns a block reduces
constexpr int UNROLL = 4;     // rounds of 32 lanes loaded before reducing
constexpr int COMBINE_THREADS = 256;

// The sums of one round: lane `lane` holds row `key` (-1: nothing) and
// its columns v[0..CW); the sum of each group of lanes with one key is
// added to the warp's table copy `mine` by the group's first lane.
template <int CW>
__device__ __forceinline__ void add_round(int key, float (&v)[CW], int nc,
                                          float* mine, int lane) {
  const unsigned peers = __match_any_sync(FULL, key);
  // the next lane of my group, or WARP at its end
  const unsigned later = peers & ~((2u << lane) - 1u);
  int next = later ? __ffs(later) - 1 : WARP;
  // pointer jumping: after step s, a lane holds the sum of itself and the
  // next 2^s - 1 lanes of its group, left + right in lane order
  while (__any_sync(FULL, next < WARP)) {
    const int src = next < WARP ? next : lane;
    float o[CW];
#pragma unroll
    for (int k = 0; k < CW; ++k) o[k] = __shfl_sync(FULL, v[k], src);
    const int onext = __shfl_sync(FULL, next, src);
    if (next < WARP) {
#pragma unroll
      for (int k = 0; k < CW; ++k) v[k] += o[k];
      next = onext;
    }
  }
  const bool first = (peers & ((1u << lane) - 1u)) == 0u;
  if (first && key >= 0) {
#pragma unroll
    for (int k = 0; k < CW; ++k)
      if (k < nc) mine[key * CW + k] += v[k];
  }
  __syncwarp();
}

// Kernel 1: block (b, y) reduces lanes [b * per_block, (b + 1) * per_block)
// onto columns [y * CW, y * CW + nc) and writes its partial table
// part[b, rows, cols] (the output itself when gridDim.x == 1).
template <int CW>
__global__ void take_grad_kernel(const long long* __restrict__ idx,
                                 const float* __restrict__ g, long long n,
                                 long long lane_s, long long col_s, int rows,
                                 int cols, long long per_block,
                                 float* __restrict__ part) {
  extern __shared__ float tables[];  // [warps][rows][CW]
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int warps = blockDim.x / WARP;
  const int c0 = blockIdx.y * CW;
  const int nc = min(CW, cols - c0);
  const int size = rows * CW;
  for (int e = threadIdx.x; e < warps * size; e += blockDim.x)
    tables[e] = 0.f;
  __syncthreads();
  float* mine = tables + warp * size;
  const long long lo = (long long)blockIdx.x * per_block;
  const long long hi = min(n, lo + per_block);
  const long long round = (long long)warps * WARP;
  for (long long base = lo + (long long)warp * WARP; base < hi;
       base += round * UNROLL) {
    int key[UNROLL];
    float v[UNROLL][CW];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * round + lane;
      key[u] = -1;
#pragma unroll
      for (int k = 0; k < CW; ++k) v[u][k] = 0.f;
      if (i < hi) {
        const long long r = __ldcs(idx + i);
        if (r >= 0 && r < rows) key[u] = (int)r;
#pragma unroll
        for (int k = 0; k < CW; ++k)
          if (k < nc) v[u][k] = __ldcs(g + i * lane_s + (c0 + k) * col_s);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      add_round<CW>(key[u], v[u], nc, mine, lane);
  }
  __syncthreads();
  // the block's partial: its warps' copies in warp order
  for (int e = threadIdx.x; e < rows * nc; e += blockDim.x) {
    const int r = e / nc, k = e - r * nc;
    float s = tables[r * CW + k];
    for (int w = 1; w < warps; ++w) s += tables[w * size + r * CW + k];
    part[((long long)blockIdx.x * rows + r) * cols + c0 + k] = s;
  }
}

// Kernel 2: out[e] = the sum of part[b, e] over blocks b, in a fixed order:
// `split` threads (a power of two up to 32) an element, thread j adding
// blocks j, j + split, ... in order, then a shuffle tree over the split.
__global__ void take_grad_combine(const float* __restrict__ part, int blocks,
                                  int elems, int split,
                                  float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long e = t / split;
  const int j = (int)(t % split);
  float s = 0.f;
  if (e < elems) {
    bool any = false;
    for (int b = j; b < blocks; b += split) {
      const float x = part[(long long)b * elems + e];
      s = any ? s + x : x;
      any = true;
    }
  }
  for (int o = split / 2; o > 0; o /= 2)
    s += __shfl_down_sync(FULL, s, o, split);
  if (e < elems && j == 0) out[e] = s;
}

template <int CW>
int launch_reduce(const long long* idx, const float* g, long long n,
                  long long lane_s, long long col_s, int rows, int cols,
                  int warps, int blocks, float* part, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)warps * rows * CW;
  cudaError_t err = cudaFuncSetAttribute(
      take_grad_kernel<CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long per_block =
      ((n + blocks - 1) / blocks + WARP - 1) / WARP * WARP;
  const dim3 grid(blocks, (cols + CW - 1) / CW);
  take_grad_kernel<CW><<<grid, warps * WARP, smem, st>>>(
      idx, g, n, lane_s, col_s, rows, cols, per_block, part);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` without
// synchronising and returns cudaGetLastError() after the last launch (0 =
// ok). idx: i64[n], contiguous (lanes whose index lies outside [0, rows)
// add nothing); lane n's column c at g[n * lane_s + c * col_s] (strides in
// elements); out: f32[rows, cols], contiguous, every element written.
// The layout: `warps` a block, `blocks` blocks, `cw` (1-4) columns a block;
// part: f32[blocks, rows, cols] when blocks > 1 (else unused, may be NULL);
// `split` threads an element in the second kernel (a power of two, <= 32).
// *kernels (host memory) receives the number of kernels launched: 0 for an
// empty table, else 1, and 2 with the combine.
extern "C" int take_grad_launch(const long long* idx, const float* g,
                                long long n, long long lane_s, long long col_s,
                                int rows, int cols, int warps, int blocks,
                                int cw, int split, float* part, float* out,
                                int* kernels, void* stream) {
  *kernels = 0;
  if (rows <= 0 || cols <= 0) return 0;
  if (n < 0 || warps < 1 || warps > 32 || blocks < 1 || cw < 1 || cw > COLS ||
      split < 1 || split > WARP || (split & (split - 1)) != 0 ||
      (blocks > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto reduce = cw == 1   ? launch_reduce<1>
                : cw == 2 ? launch_reduce<2>
                : cw == 3 ? launch_reduce<3>
                          : launch_reduce<4>;
  const int err = reduce(idx, g, n, lane_s, col_s, rows, cols, warps, blocks,
                         blocks > 1 ? part : out, st);
  if (err != 0) return err;
  *kernels = 1;
  if (blocks == 1) return 0;
  const long long elems = (long long)rows * cols;
  const unsigned grid =
      (unsigned)((elems * split + COMBINE_THREADS - 1) / COMBINE_THREADS);
  take_grad_combine<<<grid, COMBINE_THREADS, 0, st>>>(part, blocks,
                                                      (int)elems, split, out);
  const int last = (int)cudaGetLastError();
  if (last == 0) *kernels = 2;
  return last;
}
