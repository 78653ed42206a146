// Per-keypoint square patch gather over all of a frame's patch sets (K3).
//
// Replaces fastmatch_tpu/kernels/patch_gather.py:_kernel (entry
// gather_patches) together with the jnp.pad(..., "edge") its callers put in
// front of it. One launch takes up to MAX_SEGMENTS segments, each a
// contiguous (L, H, W) float32 stack, a (K, 3) int32 (level, y, x) start per
// keypoint, a patch size P and a virtual replicate pad:
//
//   out[k, r, c] = stack[clamp(l, 0, L-1), clamp(y0 + r - pad, 0, H-1),
//                        clamp(x0 + c - pad, 0, W-1)]
//   y0 = clamp(y, 0, H + 2 pad - P),  x0 = clamp(x, 0, W + 2 pad - P),
//
// which is bit for bit the padded stack's window: a copy, no arithmetic.
// The TPU version's aligned slabs, rolls and bit-packed indices were Mosaic
// workarounds and are not carried over; its edge padding is folded into the
// clamped reads, so no padded copy of any stack is made.
//
// Bound on the H100: bytes, and almost all of them writes. A SIFT frame
// writes ~121 MB of patches (the 88x88 descriptor windows overlap many
// times over) from ~10 MB of stacks that stay in the 50 MB L2. Timed apart
// (tools/patch_gather_probe.py), the stores alone reach the bound; what
// holds the copy back is the gather: per element, the window's start, its
// clamps and a scalar read from L2 at any column. The design:
//   - the segment table travels by value as a __grid_constant__ parameter
//     (no host-to-device copy); a block finds its segment by a scan of the
//     table's first blocks, so one launch covers a whole frame;
//   - a block copies BLOCK_FLOATS consecutive floats of one segment's flat
//     (K*P*P) output. It first clamps the starts of the (at most
//     MAX_KEYPOINTS) patches its range touches into a table in shared
//     memory: each element then costs one shared read, two clamps and a
//     32-bit address instead of three dependent reads of the starts;
//   - reads go lane by lane along the output, so a warp reads consecutive
//     columns of one or two stack rows; the 16 reads a thread makes are all
//     in flight before it stores;
//   - a shared-memory transpose turns them into 16-byte stores, each
//     segment's output starting on a 512-byte boundary; cache-streaming
//     (st.global.cs) so the output stream does not evict the stacks from
//     L2; a segment's ragged tail is stored element by element;
//   - patch coordinates come from the flat index by division by constants:
//     P is a template parameter for the sizes the paths use (19, 40, 64,
//     88), and one generic instance (runtime division, starts read from
//     device memory per element) takes any other size; a block takes its
//     segment's branch, so the branch is uniform.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;                          // floats a thread copies
constexpr int BLOCK_FLOATS = THREADS * PER_THREAD;      // 4096; kernels/patch_gather.py
constexpr int MAX_SEGMENTS = 32;                        // kernels/patch_gather.py
constexpr int TABLE_FIELDS = 10;                        // int64s a segment in the host table
constexpr int MIN_TEMPLATE_P = 19;                      // the smallest templated patch
constexpr int MAX_KEYPOINTS = (BLOCK_FLOATS - 1) / (MIN_TEMPLATE_P * MIN_TEMPLATE_P) + 2;

struct Segment {
  const float* stack;
  const int* lyx;
  long long out;      // offset of the segment's output, in floats
  int first_block;
  int K, L, H, W, P, pad;
};

struct Table {
  Segment seg[MAX_SEGMENTS];
  int n;
};

// Patch k's clamped start: (offset of its level, first row - pad, first
// column - pad). The wrapper keeps every stack under 2^31 elements.
__device__ __forceinline__ int4 start_of(const Segment& s, int P, int k) {
  const int* p = s.lyx + 3 * k;
  const int l = min(max(__ldg(p + 0), 0), s.L - 1);
  const int y0 = min(max(__ldg(p + 1), 0), s.H + 2 * s.pad - P);
  const int x0 = min(max(__ldg(p + 2), 0), s.W + 2 * s.pad - P);
  return make_int4(l * s.H * s.W, y0 - s.pad, x0 - s.pad, 0);
}

// Reads the block's PER_THREAD elements of the segment's flat output:
// element e = base + i * THREADS + threadIdx.x is row r, column c of patch k.
template <int PT>
__device__ __forceinline__ void gather(const Segment& s, int base, float (&v)[PER_THREAD],
                                       int4* starts) {
  static_assert(PT == 0 || PT >= MIN_TEMPLATE_P, "the start table is sized for P >= 19");
  const int P = PT > 0 ? PT : s.P;
  const int PP = P * P;
  const int n = s.K * PP;
  int k0 = 0;
  if (PT > 0) {
    k0 = base / PP;
    const int nk = min((base + BLOCK_FLOATS - 1) / PP, s.K - 1) - k0 + 1;
    if (static_cast<int>(threadIdx.x) < nk) starts[threadIdx.x] = start_of(s, P, k0 + threadIdx.x);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = base + i * THREADS + threadIdx.x;
    float x = 0.f;
    if (e < n) {
      const int k = e / PP;
      const int rem = e - k * PP;
      const int r = rem / P;
      const int c = rem - r * P;
      const int4 t = PT > 0 ? starts[k - k0] : start_of(s, P, k);
      const int y = min(max(t.y + r, 0), s.H - 1);
      x = __ldg(s.stack + (t.x + y * s.W + min(max(t.z + c, 0), s.W - 1)));
    }
    v[i] = x;
  }
}

__global__ void __launch_bounds__(THREADS)
gather_patch_sets_kernel(const __grid_constant__ Table t, float* __restrict__ out) {
  __shared__ __align__(16) float tile[BLOCK_FLOATS];
  __shared__ int4 starts[MAX_KEYPOINTS];
  int si = 0;
  while (si + 1 < t.n && static_cast<int>(blockIdx.x) >= t.seg[si + 1].first_block) ++si;
  const Segment& s = t.seg[si];
  const int base = (blockIdx.x - s.first_block) * BLOCK_FLOATS;
  float v[PER_THREAD];
  switch (s.P) {
    case 19: gather<19>(s, base, v, starts); break;
    case 40: gather<40>(s, base, v, starts); break;
    case 64: gather<64>(s, base, v, starts); break;
    case 88: gather<88>(s, base, v, starts); break;
    default: gather<0>(s, base, v, starts); break;
  }
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) tile[i * THREADS + threadIdx.x] = v[i];
  __syncthreads();
  const int n = s.K * s.P * s.P;
  float* dst = out + s.out;
#pragma unroll
  for (int i = 0; i < PER_THREAD / 4; ++i) {
    const int q = i * THREADS + threadIdx.x;
    const int e = base + 4 * q;
    if (e + 4 <= n) {
      __stcs(reinterpret_cast<float4*>(dst + e), reinterpret_cast<const float4*>(tile)[q]);
    } else {
      for (int j = 0; e + j < n; ++j) __stcs(dst + e + j, tile[4 * q + j]);
    }
  }
}

}  // namespace

// table: n_segments rows of TABLE_FIELDS int64s (stack address, lyx address,
// output offset in floats, first block, K, L, H, W, P, pad), as planned by
// kernels/patch_gather.py:plan_patch_sets; blocks: the launch's total.
extern "C" int fm_gather_patch_sets(const long long* table, int n_segments, int blocks,
                                    float* out, void* stream) {
  if (n_segments < 1 || n_segments > MAX_SEGMENTS || blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  Table t;
  t.n = n_segments;
  for (int s = 0; s < n_segments; ++s) {
    const long long* f = table + TABLE_FIELDS * s;
    t.seg[s] = Segment{reinterpret_cast<const float*>(f[0]), reinterpret_cast<const int*>(f[1]),
                       f[2], static_cast<int>(f[3]), static_cast<int>(f[4]),
                       static_cast<int>(f[5]), static_cast<int>(f[6]), static_cast<int>(f[7]),
                       static_cast<int>(f[8]), static_cast<int>(f[9])};
  }
  gather_patch_sets_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(t, out);
  return static_cast<int>(cudaGetLastError());
}
