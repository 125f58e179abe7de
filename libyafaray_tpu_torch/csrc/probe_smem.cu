// Shared-memory capacity probe, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `kern` in try_mb (tools/probe_traversal.py:27,
// pallas_call :32), which binary-searched the largest VMEM scratch a Pallas
// kernel can hold: it writes ones to the first and last 8x128 floats of an
// `mb`-sized scratch and returns their sum, f32[8, 128] of 2.0. On the H100
// the on-chip scratch of a kernel is its block's shared memory, above 48 KB
// only as dynamic shared memory after an opt-in through
// cudaFuncSetAttribute. The kernel does the same writes and sum in `nbytes`
// of dynamic shared memory; the wrapper (accel/probe_smem.py) binary-searches
// the largest launch that succeeds, which is the card's opt-in limit per
// block (cudaDevAttrMaxSharedMemoryPerBlockOptin, read by
// probe_smem_optin_limit for the plain version).
//
// What bounds it: nothing measurable. One block of 128 threads writes 8 KB
// of shared memory and 4 KB of output; its time is the launch.
#include <cuda_runtime.h>

namespace {

constexpr int COLS = 128;  // floats per row, one thread per column
constexpr int ROWS = 8;    // rows written at each end

__global__ void __launch_bounds__(COLS)
    probe_smem_kernel(float* __restrict__ out, int rows) {
  extern __shared__ float scratch[];
  const int x = threadIdx.x;
  for (int r = 0; r < ROWS; ++r) {
    scratch[r * COLS + x] = 1.0f;
    scratch[(rows - ROWS + r) * COLS + x] = 1.0f;
  }
  __syncthreads();
  for (int r = 0; r < ROWS; ++r)
    out[r * COLS + x] =
        scratch[r * COLS + x] + scratch[(rows - ROWS + r) * COLS + x];
}

}  // namespace

// Launch the probe with `nbytes` of dynamic shared memory (a multiple of
// 512 bytes, at least 8 KB) on `stream`, writing out f32[8, 128]. Returns 0,
// or the CUDA error of the opt-in or of the launch (a size above the card's
// limit is refused there and never runs).
extern "C" int probe_smem_launch(float* out, int nbytes, void* stream) {
  const int row_bytes = COLS * (int)sizeof(float);
  if (nbytes < 2 * ROWS * row_bytes || nbytes % row_bytes != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      probe_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not sticky: clear it for the next attempt
    return (int)err;
  }
  probe_smem_kernel<<<1, COLS, nbytes, static_cast<cudaStream_t>(stream)>>>(
      out, nbytes / row_bytes);
  return (int)cudaGetLastError();
}

// The card's opt-in limit of shared memory per block, in bytes.
extern "C" int probe_smem_optin_limit(int device, int* nbytes) {
  return (int)cudaDeviceGetAttribute(
      nbytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
