// Sorted row gather (K5): out[o, :] = table[seg[o], :].
//
// Replaces fastmatch_tpu/kernels/segment_ops.py:_gather_kernel (entry
// sorted_gather_rows). The TPU kernel is a windowed one-hot product split
// into bf16 hi/lo parts (about 2^-16 relative); this one copies the words,
// so it is exact. Keys outside [0, n_rows) give zero rows, as the one-hot
// product does.
//
// Bound on the H100: bytes only (no arithmetic): the keys, the output, and
// the table rows the keys name, over 3.35 TB/s. BA's call moves ~0.3 MB, so
// a launch costs more than its bytes and the design keeps the work per
// element to a load and a store:
// - D <= 4 (BA's D = 3): one thread per output row, D compile-time, so the
//   row's D loads and D stores need no division per element;
// - wider D: a 2-D block of (rows x lanes), lanes the power of two >= D
//   (at most 32), each lane striding over the row's columns.
// Sorted keys make neighbouring threads read the same or neighbouring
// table rows, and each warp writes one contiguous stretch of the output.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int D>
__global__ void __launch_bounds__(THREADS)
gather_rows_narrow(const float* __restrict__ table, const int* __restrict__ seg, int O,
                   int n_rows, float* __restrict__ out) {
  const int o = blockIdx.x * THREADS + threadIdx.x;
  if (o >= O) return;
  const int s = seg[o];
  const bool inside = s >= 0 && s < n_rows;
  const float* src = table + static_cast<size_t>(inside ? s : 0) * D;
  float* dst = out + static_cast<size_t>(o) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) dst[c] = inside ? src[c] : 0.f;
}

__global__ void __launch_bounds__(THREADS)
gather_rows_wide(const float* __restrict__ table, const int* __restrict__ seg, int O,
                 int n_rows, int D, int lane_bits, float* __restrict__ out) {
  const int lanes = 1 << lane_bits;
  const int o = blockIdx.x * (THREADS >> lane_bits) + (threadIdx.x >> lane_bits);
  if (o >= O) return;
  const int s = seg[o];
  const bool inside = s >= 0 && s < n_rows;
  const float* src = table + static_cast<size_t>(inside ? s : 0) * D;
  float* dst = out + static_cast<size_t>(o) * D;
  for (int c = threadIdx.x & (lanes - 1); c < D; c += lanes) dst[c] = inside ? src[c] : 0.f;
}

}  // namespace

extern "C" int fm_gather_rows(const float* table, const int* seg, int O, int n_rows, int D,
                              float* out, void* stream) {
  if (O == 0 || D == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int narrow_blocks = (O + THREADS - 1) / THREADS;
  switch (D) {
    case 1: gather_rows_narrow<1><<<narrow_blocks, THREADS, 0, st>>>(table, seg, O, n_rows, out); break;
    case 2: gather_rows_narrow<2><<<narrow_blocks, THREADS, 0, st>>>(table, seg, O, n_rows, out); break;
    case 3: gather_rows_narrow<3><<<narrow_blocks, THREADS, 0, st>>>(table, seg, O, n_rows, out); break;
    case 4: gather_rows_narrow<4><<<narrow_blocks, THREADS, 0, st>>>(table, seg, O, n_rows, out); break;
    default: {
      int lane_bits = 0;
      while ((1 << lane_bits) < D && lane_bits < 5) ++lane_bits;
      const int rows = THREADS >> lane_bits;
      const unsigned int blocks = (O + rows - 1) / rows;
      gather_rows_wide<<<blocks, THREADS, 0, st>>>(table, seg, O, n_rows, D, lane_bits, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
