// Sorted row gather (K5): out[o, :] = table[seg[o], :].
//
// Replaces fastmatch_tpu/kernels/segment_ops.py:_gather_kernel (entry
// sorted_gather_rows). The TPU kernel is a windowed one-hot product split
// into bf16 hi/lo parts (about 2^-16 relative); this one copies the words,
// so it is exact. Keys outside [0, n_rows) give zero rows, as the one-hot
// product does.
//
// Bound on the H100: bytes only (no arithmetic): the keys, the output, and
// the table rows the keys name, over 3.35 TB/s. Consecutive threads take
// consecutive (row, column) elements of the output, so the writes are
// coalesced; the keys are sorted (the BA table is sorted by point), so
// neighbouring threads read the same or neighbouring table rows.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gather_rows(const float* __restrict__ table, const int* __restrict__ seg, int O, int n_rows,
            int D, float* __restrict__ out) {
  const size_t total = static_cast<size_t>(O) * D;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const size_t o = e / D;
    const int c = static_cast<int>(e - o * D);
    const int s = seg[o];
    out[e] = (s >= 0 && s < n_rows) ? table[static_cast<size_t>(s) * D + c] : 0.f;
  }
}

}  // namespace

extern "C" int fm_gather_rows(const float* table, const int* seg, int O, int n_rows, int D,
                              float* out, void* stream) {
  const size_t total = static_cast<size_t>(O) * D;
  if (total == 0) return 0;
  size_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  gather_rows<<<static_cast<unsigned int>(blocks), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(table, seg, O, n_rows, D, out);
  return static_cast<int>(cudaGetLastError());
}
