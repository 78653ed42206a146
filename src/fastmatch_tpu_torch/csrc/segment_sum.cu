// Deterministic sorted segment sum (K4).
//
// Replaces fastmatch_tpu/kernels/segment_ops.py:_segsum_kernel (entry
// sorted_segment_sum): out[s] = sum of vals[o] over rows with seg[o] == s,
// for seg sorted ascending. The caller passes the segment offsets off
// (n + 1 entries, off[s] = the first row whose key is >= s), built once per
// solve from the sorted keys as the JAX package builds its tile table
// outside the pallas_call; rows outside [off[0], off[n]) have keys outside
// [0, n) and are dropped, as jax.ops.segment_sum drops them. The kernel
// reads no keys.
//
// Bound on the H100: bytes (O*D adds against O*D words read, n*D written
// and n+1 offsets read, over 3.35 TB/s): a fraction of a microsecond at
// BA's shapes, so the grid's shape and the latency of its loads decide the
// time, not arithmetic. Two variants, one launch per call; the wrapper
// picks by the longest segment (known once per solve):
// - short segments (a point's rows: at most one per frame): one thread per
//   (segment, column), n*D threads in all. A thread adds its segment's
//   rows in row order. No shared memory, no barrier, no search.
// - long segments (a camera's rows: hundreds to thousands): one block per
//   segment. Thread t takes row lane t / D and column t % D, so each pass
//   over the segment reads one contiguous stretch of its rows; each lane
//   adds its rows in row order, and the lanes of a column are then added
//   by a fixed-shape shared-memory tree.
// Both summation orders depend only on the offsets, D and the block size,
// so two runs are bit-identical (no float atomics). Sums are fp32; the TPU
// kernel's bf16 hi/lo split is not needed. D is a template parameter for
// BA's widths (3, 6, 9, 36), so the divisions by D become multiplies.

#include <cuda_runtime.h>

namespace {

constexpr int SHORT_THREADS = 256;
constexpr int LONG_THREADS = 512;

template <int D>
__global__ void __launch_bounds__(SHORT_THREADS)
segsum_short(const float* __restrict__ vals, const int* __restrict__ off, int n, int d_rt,
             float* __restrict__ out) {
  const int d = D > 0 ? D : d_rt;
  const int t = blockIdx.x * SHORT_THREADS + threadIdx.x;
  if (t >= n * d) return;
  const int s = t / d;
  const int c = t - s * d;
  const int hi = off[s + 1];
  float acc = 0.f;
#pragma unroll 4
  for (int o = off[s]; o < hi; ++o) acc += vals[static_cast<size_t>(o) * d + c];
  out[t] = acc;
}

template <int D>
__global__ void __launch_bounds__(LONG_THREADS)
segsum_long(const float* __restrict__ vals, const int* __restrict__ off, int d_rt,
            float* __restrict__ out) {
  __shared__ float part[LONG_THREADS];
  const int d = D > 0 ? D : d_rt;
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  const int lo = off[s], hi = off[s + 1];
  if (lo == hi) {  // the same for the whole block
    if (t < d) out[static_cast<size_t>(s) * d + t] = 0.f;
    return;
  }
  const int lanes = LONG_THREADS / d;
  const int r = t / d;
  const int c = t - r * d;
  float acc = 0.f;
  if (r < lanes) {
#pragma unroll 4
    for (int o = lo + r; o < hi; o += lanes) acc += vals[static_cast<size_t>(o) * d + c];
  }
  part[t] = acc;
  __syncthreads();
  int h = 1;
  while (h * 2 < lanes) h *= 2;
  for (; h > 0; h >>= 1) {  // lane r += lane r + h, for the lanes still live
    if (r < h && r + h < lanes) part[t] += part[t + h * d];
    __syncthreads();
  }
  if (t < d) out[static_cast<size_t>(s) * d + t] = part[t];
}

template <int D>
void launch(const float* vals, const int* off, int n, int d, int long_segments, float* out,
            cudaStream_t st) {
  if (long_segments) {
    segsum_long<D><<<n, LONG_THREADS, 0, st>>>(vals, off, d, out);
  } else {
    const int blocks = (n * d + SHORT_THREADS - 1) / SHORT_THREADS;
    segsum_short<D><<<blocks, SHORT_THREADS, 0, st>>>(vals, off, n, d, out);
  }
}

}  // namespace

// vals (O, D) rows sorted by key; off (n + 1) segment offsets into them;
// out (n, D). D <= LONG_THREADS and n * D < 2^31, checked by the wrapper.
extern "C" int fm_sorted_segment_sum(const float* vals, const int* off, int n, int D,
                                     int long_segments, float* out, void* stream) {
  if (n == 0 || D == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 3: launch<3>(vals, off, n, D, long_segments, out, st); break;
    case 6: launch<6>(vals, off, n, D, long_segments, out, st); break;
    case 9: launch<9>(vals, off, n, D, long_segments, out, st); break;
    case 36: launch<36>(vals, off, n, D, long_segments, out, st); break;
    default: launch<0>(vals, off, n, D, long_segments, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}
