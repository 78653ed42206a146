// Deterministic sorted segment sum (K4).
//
// Replaces fastmatch_tpu/kernels/segment_ops.py:_segsum_kernel (entry
// sorted_segment_sum): out[s] = sum of vals[o] over rows with seg[o] == s,
// for seg sorted ascending. Rows whose key lies outside [0, n_segments) are
// dropped, as jax.ops.segment_sum drops them.
//
// Bound on the H100: O*D adds against O*(D+1) words read and n*D written,
// so bytes over 3.35 TB/s. One block per segment: it finds the segment's
// row range by binary search on the sorted keys, then threads are laid out
// as (row lane, column) so each pass over the range reads whole rows
// (coalesced). Each thread sums its rows in increasing order and a single
// thread per column adds the lanes in lane order: the summation order
// depends only on the segment's range, so two runs are bit-identical. Sums
// are fp32 with no float atomics, and the TPU kernel's bf16 hi/lo split is
// not needed. Camera-keyed (unsorted) keys are sorted once per solve by the
// caller (ba/schur.py) and take the same kernel.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int lower_bound(const int* __restrict__ keys, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
segsum_sorted(const float* __restrict__ vals, const int* __restrict__ seg, int O,
              int D, float* __restrict__ out) {
  __shared__ int range[2];
  __shared__ float part[THREADS];
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  if (t < 2) range[t] = lower_bound(seg, O, s + t);
  __syncthreads();
  const int lo = range[0], hi = range[1];
  const int lanes = THREADS / D;
  const int r = t / D;
  const int c = t - r * D;
  float acc = 0.f;
  if (r < lanes) {
    for (int o = lo + r; o < hi; o += lanes) acc += vals[static_cast<size_t>(o) * D + c];
  }
  part[t] = acc;
  __syncthreads();
  if (t < D) {
    float sum = 0.f;
    for (int q = 0; q < lanes; ++q) sum += part[q * D + t];
    out[static_cast<size_t>(s) * D + t] = sum;
  }
}

}  // namespace

extern "C" int fm_sorted_segment_sum(const float* vals, const int* seg, int O, int D,
                                     int n_segments, float* out, void* stream) {
  if (n_segments == 0) return 0;
  segsum_sorted<<<n_segments, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      vals, seg, O, D, out);
  return static_cast<int>(cudaGetLastError());
}
