// Per-keypoint square patch gather from an (L, H, W) stack (K3).
//
// Replaces fastmatch_tpu/kernels/patch_gather.py:_kernel (entry
// gather_patches): out[k] = stack[l, y:y+P, x:x+P] for each (l, y, x) row of
// lyx, with l clamped to [0, L-1], y to [0, H-P] and x to [0, W-P] against
// the stack as given (the TPU version's alignment padding and bit-packed
// indices were Mosaic workarounds and are not carried over).
//
// Bound on the H100: pure data movement, K*P*P floats written and at most
// as many read (fewer where windows overlap), so bytes over 3.35 TB/s. One
// block copies the windows of a group of keypoints; consecutive threads take
// consecutive elements of a patch row, so reads along a stack row and
// writes of the contiguous output patch are coalesced. Overlapping windows
// of neighbouring keypoints are served from L2.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int KEYPOINTS_PER_BLOCK = 4;

__global__ void __launch_bounds__(THREADS)
gather_patches_kernel(const float* __restrict__ stack, const int* __restrict__ lyx,
                      int K, int L, int H, int W, int P, float* __restrict__ out) {
  for (int kk = 0; kk < KEYPOINTS_PER_BLOCK; ++kk) {
    const int k = blockIdx.x * KEYPOINTS_PER_BLOCK + kk;
    if (k >= K) return;
    const int l = min(max(lyx[3 * k + 0], 0), L - 1);
    const int y = min(max(lyx[3 * k + 1], 0), H - P);
    const int x = min(max(lyx[3 * k + 2], 0), W - P);
    const float* src = stack + (static_cast<size_t>(l) * H + y) * W + x;
    float* dst = out + static_cast<size_t>(k) * P * P;
    for (int e = threadIdx.x; e < P * P; e += THREADS) {
      const int r = e / P;
      const int c = e - r * P;
      dst[e] = src[static_cast<size_t>(r) * W + c];
    }
  }
}

}  // namespace

extern "C" int fm_gather_patches(const float* stack, const int* lyx, int K, int L,
                                 int H, int W, int P, float* out, void* stream) {
  if (K == 0) return 0;
  const int blocks = (K + KEYPOINTS_PER_BLOCK - 1) / KEYPOINTS_PER_BLOCK;
  gather_patches_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      stack, lyx, K, L, H, W, P, out);
  return static_cast<int>(cudaGetLastError());
}
