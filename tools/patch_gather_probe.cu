// Probes of K3's two halves, for tools/patch_gather_probe.py: the shipped
// kernel's block-to-segment mapping with only its stores (a constant, the
// same 16-byte cache-streaming stores) or only its gather (start table and
// reads, one conditional store a block). Built beside the shipped source,
// which it includes, so both halves are the shipped code.

#include "../src/fastmatch_tpu_torch/csrc/patch_gather.cu"

namespace {

__global__ void __launch_bounds__(THREADS)
probe_stores_kernel(const __grid_constant__ Table t, float* __restrict__ out) {
  int si = 0;
  while (si + 1 < t.n && static_cast<int>(blockIdx.x) >= t.seg[si + 1].first_block) ++si;
  const Segment& s = t.seg[si];
  const int base = (blockIdx.x - s.first_block) * BLOCK_FLOATS;
  const int n = s.K * s.P * s.P;
#pragma unroll
  for (int i = 0; i < PER_THREAD / 4; ++i) {
    const int e = base + 4 * (i * THREADS + threadIdx.x);
    if (e + 4 <= n)
      __stcs(reinterpret_cast<float4*>(out + s.out + e), make_float4(1.f, 2.f, 3.f, 4.f));
  }
}

__global__ void __launch_bounds__(THREADS)
probe_gathers_kernel(const __grid_constant__ Table t, float* __restrict__ out) {
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
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) acc += v[i];
  if (acc == -1.f) out[s.out] = acc;  // keeps the reads; never true for the probe's inputs
}

}  // namespace

// mode 0: stores only; 1: gathers only. The table as for fm_gather_patch_sets.
extern "C" int fm_patch_gather_probe(int mode, const long long* table, int n_segments,
                                     int blocks, float* out, void* stream) {
  if (n_segments < 1 || n_segments > MAX_SEGMENTS || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  t.n = n_segments;
  for (int s = 0; s < n_segments; ++s) {
    const long long* f = table + TABLE_FIELDS * s;
    t.seg[s] = Segment{reinterpret_cast<const float*>(f[0]), reinterpret_cast<const int*>(f[1]),
                       f[2], static_cast<int>(f[3]), static_cast<int>(f[4]),
                       static_cast<int>(f[5]), static_cast<int>(f[6]), static_cast<int>(f[7]),
                       static_cast<int>(f[8]), static_cast<int>(f[9])};
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) probe_stores_kernel<<<blocks, THREADS, 0, st>>>(t, out);
  else probe_gathers_kernel<<<blocks, THREADS, 0, st>>>(t, out);
  return static_cast<int>(cudaGetLastError());
}
