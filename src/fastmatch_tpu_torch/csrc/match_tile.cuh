// Block-level tile engine shared by the two fused matchers, K1
// (csrc/batch_match.cu) and K2 (csrc/distance_topk.cu).
//
// One 256-thread block owns BQ = 128 query rows of one pair and sweeps a
// column range of that pair's bank in tiles (128 bank rows in exact mode,
// 64 in the tensor-core modes). For every tile it forms s = scale * (a . b)
// (K1 folds -2 into the query operand and passes scale 1; K2 passes scale
// -2) and runs the epilogue both kernels share:
//   - row top-2 of s + b2m[j] in registers, in increasing column order, the
//     lowest index winning ties; merged over the lanes that share a row at
//     the end and written as a (v1, i1, v2) partial per (split, pair, row);
//   - with do_col, the per-bank-row minimum over the block's queries, as a
//     64-bit atomicMin on (order-preserving float bits << 32 | query):
//     COL_INDEX keys s + a2m[q] with the query (lowest query wins ties),
//     COL_VALUE keys (s + b2m[j]) + a2m[q] on the value alone.
// The (N, M) product never reaches device memory. The caller's finalize
// kernel merges the partials in split (= column) order with merge_top2.
//
// Bound on the H100: 2 N M D operations against (N + M) D operand words,
// so at the matchers' shapes every mode is operation-bound (fp32 67e12,
// bf16 989e12, int8 1979e12 per second); the tensor-core modes end up
// bound by their epilogue, ~9 instructions per product element.
//
// Three ways to form the product, one per MODE:
//   MODE_EXACT  fp32 on the CUDA cores (the parity contract forbids TF32):
//               the query tile stays in shared memory, row-major with a
//               padded stride, for the block's life; bank tiles stream in
//               32-deep chunks through a 3-stage cp.async ring, so the next
//               chunk loads while this one multiplies. Each thread owns an
//               8 x 8 block (queries ty + 16 i, bank rows tx + 16 j) and
//               reads float4s along the depth: 16 shared loads per 256 FMAs.
//   MODE_BF16   bf16 operands, fp32 sums on the tensor cores: wgmma
//               m64n64k16 with the 64-row bank tile on the M side and each
//               warpgroup's 64 queries on the N side, both K-major in the
//               128-byte swizzled layout wgmma reads; cp.async keeps a
//               4-stage ring of bank tiles 3 tiles ahead.
//   MODE_BINARY packed 32-bit words, unpacked on their way into shared
//               memory to one byte of +-1 per bit (bit 1 -> +1); wgmma
//               m64n64k32 .s32.s8.s8 forms dot = n_bits - 2 * hamming
//               exactly, and s = -2 * dot = 4 * hamming - 2 * n_bits, the
//               value the popcount matcher forms, bit for bit. Up to 8
//               words a row, a bank tile's words load into registers a tile
//               ahead; more words run depth chunk by chunk.
// Query rows past n and bank rows past the range are read clamped and
// dropped by the epilogue.
//
// Depth. The resident query tile bounds the depth a block can hold: 128
// KiB of fp32 queries at D = 256, and 256 KiB at D = 512, past the 227 KiB
// a block may have. So deeper rows (DEEP: D > RESIDENT_DIM values, or more
// than RESIDENT_WORDS packed words) run a depth loop in which the query
// tile streams chunk by chunk beside the bank tile: every ring stage holds
// one depth chunk of both (exact: 32 deep; bf16: 64 deep, one 128-byte
// panel; binary: 8 packed words), and the accumulators stay in registers
// across a tile's chunks. The queries are then read once per bank tile
// (from L2) instead of once per block; shared memory no longer grows with
// the depth, so no depth is refused (binary: up to MAX_WORDS, where the
// +-1 dot product stays exact as a float). Shallower rows keep the
// resident layouts above and their code (DEEP is a template argument).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Everything here has internal linkage (an unnamed namespace): K1's and
// K2's libraries each keep their own kernels and their own once-per-
// instantiation flags, which a shared template symbol would merge across
// the two loaded libraries.
namespace fm {
namespace {

constexpr int BQ = 128;          // query rows per block
constexpr int BN = 128;          // bank rows per tile
constexpr int THREADS = 256;     // 16 x 16 (exact) or two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr float BIG = 3.0e38f;
constexpr int NO_INDEX = 0x7fffffff;
constexpr int RESIDENT_DIM = 256;   // deepest fp32 / bf16 rows with a resident query tile
constexpr int RESIDENT_WORDS = 64;  // most packed words with resident packed queries
constexpr int MAX_WORDS = 1 << 16;  // packed words per binary row (|dot| < 2^22)
constexpr int KC = 32;           // exact: depth chunk of a bank tile
constexpr int STAGES = 3;        // exact: cp.async ring depth
constexpr int LDB = KC + 4;      // exact: padded bank chunk stride (floats)
constexpr int CHUNK_WORDS = 8;   // binary: packed words per depth chunk
constexpr int BNW = 64;          // tensor-core modes: bank rows per tile
constexpr int WSTAGES = 4;       // tensor-core modes: bank tiles in flight
constexpr int KCH = 64;          // bf16, DEEP: depth chunk (one 128-byte panel)

enum { MODE_EXACT = 0, MODE_BF16 = 1, MODE_BINARY = 2 };
enum { COL_INDEX = 1, COL_VALUE = 2 };

struct TileArgs {
  const void* a;        // (pairs, n, d) fp32, bf16, or packed words
  const void* b;        // (pairs, m, d)
  const float* a2m;     // (pairs, n) masked squared norms (BIG where dead)
  const float* b2m;     // (pairs, m)
  int n, m, d;          // d: values per row, or words per row (binary)
  int pairs;
  int cols_per_split;   // a multiple of BN
  int do_col;
  float scale;
  int skip_dead;        // dead bank tiles may be skipped (K1; see plan_live_tiles)
  const float* a2raw;   // (pairs, n) unmasked squared norms; null: known below
  const float* b2raw;   // (pairs, m)   SKIP_NORM_LIMIT (binary's constant norm)
  float* part_v1;       // (splits, pairs, n)
  int* part_i1;
  float* part_v2;
  unsigned long long* col_key;  // (pairs, m), preset to all ones
};

__device__ __forceinline__ unsigned int order_bits(float v) {
  v = v + 0.0f;  // -0 -> +0: equal values must share a key
  const unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Merge another (v1, i1, v2) summary into this one; equal v1 -> lower index.
__device__ __forceinline__ void merge_top2(float& v1, int& i1, float& v2,
                                           float ov1, int oi1, float ov2) {
  if (ov1 < v1 || (ov1 == v1 && oi1 < i1)) {
    v2 = fminf(ov2, v1);
    v1 = ov1;
    i1 = oi1;
  } else {
    v2 = fminf(v2, ov1);
  }
}

// One more column, seen in increasing column order: the old best becomes
// the runner-up when s beats it, else s competes for runner-up.
__device__ __forceinline__ void push_top2(float& v1, int& i1, float& v2, float s, int col) {
  v2 = fminf(v2, fmaxf(v1, s));
  const bool lt = s < v1;
  v1 = lt ? s : v1;
  i1 = lt ? col : i1;
}

__device__ __forceinline__ void merge_lanes(float& v1, int& i1, float& v2, int off) {
  const float ov1 = __shfl_xor_sync(0xffffffffu, v1, off);
  const int oi1 = __shfl_xor_sync(0xffffffffu, i1, off);
  const float ov2 = __shfl_xor_sync(0xffffffffu, v2, off);
  merge_top2(v1, i1, v2, ov1, oi1, ov2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes (cp.async, st.shared) made visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator traffic across wgmma.
template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzled layout:
// 128-byte rows, 8-row groups 1024 bytes apart (SBO), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of 16-byte chunk `c16` (along the depth) of row `r` in a
// swizzled tile of `rows` rows: 128-byte panels of depth, each rows x 128.
__device__ __forceinline__ uint32_t sw128_offset(int r, int c16, int rows) {
  return static_cast<uint32_t>((c16 >> 3) * rows * 128 + r * 128 +
                               (((c16 & 7) ^ (r & 7)) << 4));
}

// An int of magnitude below 2^22 as a float, exactly, by the 1.5 * 2^23
// trick (two full-rate instructions instead of the quarter-rate I2F).
__device__ __forceinline__ float int_to_float(int x) {
  return __int_as_float(x + 0x4B400000) - 12582912.0f;
}

// Four bits -> four bytes of +-1 (bit k -> byte k; 1 -> +1, 0 -> -1).
__device__ __forceinline__ uint32_t pm1x4(uint32_t nib) {
  return 0xFFFFFFFFu ^ (((nib * 0x00204081u) & 0x01010101u) * 0xFEu);
}
// Bits 16h .. 16h + 15 of a packed word -> 16 bytes of +-1.
__device__ __forceinline__ uint4 unpack16(uint32_t w, int h) {
  const uint32_t x = w >> (16 * h);
  return make_uint4(pm1x4(x & 0xF), pm1x4((x >> 4) & 0xF), pm1x4((x >> 8) & 0xF),
                    pm1x4((x >> 12) & 0xF));
}

// wgmma of a 64-row bank tile (M) with a warpgroup's 64 queries (N), both
// operands read from shared memory through descriptors; acc = 0 would
// ignore the sums held in d (the kernels zero d and pass 1).
__device__ __forceinline__ void mma_bf16(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

__device__ __forceinline__ void mma_s8(int* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

// Dynamic shared memory of one block (host and device agree on it).
__host__ __device__ inline int panels_of(int depth_bytes) { return (depth_bytes + 127) / 128; }

// Whether rows of depth d (values, or packed words) run the depth loop.
__host__ __device__ inline bool deep_of(int mode, int d) {
  return d > (mode == MODE_BINARY ? RESIDENT_WORDS : RESIDENT_DIM);
}

__host__ __device__ inline size_t smem_bytes(int mode, int d) {
  const bool deep = deep_of(mode, d);
  if (mode == MODE_EXACT) {
    // DEEP: a ring of query and bank chunks
    return sizeof(float) * (deep ? STAGES * (BQ + BN) * LDB : BQ * (d + 4) + STAGES * BN * LDB);
  }
  if (mode == MODE_BF16) {
    if (deep) return 1024 + WSTAGES * (BNW + BQ) * 128;  // ring of bank and query panels
    const size_t tile = 128 * panels_of(2 * d);  // bytes per row of a tile
    return 1024 + (BQ + WSTAGES * BNW) * tile;   // 1024: alignment slack
  }
  if (d <= CHUNK_WORDS) return 1024 + (BQ + 2 * BNW) * (32 * d);  // +-1 queries, 2 bank stages
  // +-1 chunks, then the packed bank ring and the packed queries (DEEP: a
  // ring of packed bank and query chunks)
  const size_t unpacked = 1024 + (BQ + BNW) * (32 * CHUNK_WORDS);
  if (deep) return unpacked + WSTAGES * (BNW + BQ) * 4 * CHUNK_WORDS;
  return unpacked + (WSTAGES * BNW + BQ) * 4 * d;
}

// Column candidate from two (value, query) pairs of other lanes: the
// lower value, then the lower query.
__device__ __forceinline__ void take_lower(float& best, int& brow, float ov, int orow) {
  if (ov < best || (ov == best && orow < brow)) {
    best = ov;
    brow = orow;
  }
}

// Column candidates of the 8 warps for the tile's 128 bank rows: the
// lowest (value, query) per warp, then one atomicMin per bank row.
struct ColumnScratch {
  float v[WARPS][BN];
  int r[WARPS][BN];
};

template <int COL>
__device__ __forceinline__ void commit_columns(ColumnScratch& cs, int c0, int col_end,
                                               unsigned long long* col_key) {
  __syncthreads();
  const int t = threadIdx.x;
  if (t < BN && c0 + t < col_end) {
    float best = cs.v[0][t];
    int brow = COL == COL_INDEX ? cs.r[0][t] : 0;
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      if constexpr (COL == COL_INDEX) {
        take_lower(best, brow, cs.v[w][t], cs.r[w][t]);
      } else {
        best = fminf(best, cs.v[w][t]);
      }
    }
    // COL_VALUE candidates carry no query: a value below +inf is one.
    if (COL == COL_INDEX ? brow != NO_INDEX : best < __int_as_float(0x7f800000)) {
      const unsigned long long key =
          (static_cast<unsigned long long>(order_bits(best)) << 32) |
          (COL == COL_INDEX ? static_cast<unsigned int>(brow) : 0u);
      atomicMin(col_key + c0 + t, key);
    }
  }
}

struct Block {
  int p, row0, col_begin, col_end;
  const float* a2m;
  const float* b2m;
  unsigned long long* col_key;
  size_t part;  // offset of this (split, pair) in the partial arrays
  int ntiles;   // bank tiles this block sweeps
  const unsigned char* tile_ids;  // their indices in the split; null: 0 .. ntiles - 1
  __device__ int tile(int t) const { return tile_ids ? tile_ids[t] : t; }
};

// ---------------------------------------------------------------------------
// MODE_EXACT: fp32 FMAs on the CUDA cores.

template <int COL, bool DEEP>
__device__ __forceinline__ void simt_tiles(const TileArgs& g, const Block& k,
                                           unsigned char* smem, ColumnScratch& cs) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // bank rows tx + 16 j
  const int ty = tid >> 4;   // queries ty + 16 i
  const int warp = tid >> 5;
  // DEEP: the query tile is a ring of 32-deep chunks too, one per stage.
  const int d = g.d, lda = DEEP ? LDB : d + 4, d4 = d / 4;
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + (DEEP ? STAGES * BQ * LDB : BQ * lda);
  const float* a = static_cast<const float*>(g.a) + static_cast<size_t>(k.p) * g.n * d;
  const float* b = static_cast<const float*>(g.b) + static_cast<size_t>(k.p) * g.m * d;

  if constexpr (!DEEP) {
    for (int c = tid; c < BQ * d4; c += THREADS) {
      const int r = c / d4, q = c - r * d4;
      const int gr = min(k.row0 + r, g.n - 1);
      cp_async16(As + r * lda + 4 * q, a + static_cast<size_t>(gr) * d + 4 * q);
    }
  }
  const int nch = d / KC;
  const int steps = k.ntiles * nch;
  auto load_tile = [&](int s) {
    const int t = s / nch, ch = s - t * nch;
    const int c0 = k.col_begin + k.tile(t) * BN;
    float* dst = Bs + (s % STAGES) * BN * LDB;
#pragma unroll
    for (int i = 0; i < BN * KC / 4 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (KC / 4), q = c % (KC / 4);
      const int gc = min(c0 + r, g.m - 1);
      cp_async16(dst + r * LDB + 4 * q, b + static_cast<size_t>(gc) * d + ch * KC + 4 * q);
    }
    if constexpr (DEEP) {
      float* adst = As + (s % STAGES) * BQ * LDB;
#pragma unroll
      for (int i = 0; i < BQ * KC / 4 / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int r = c / (KC / 4), q = c % (KC / 4);
        const int gr = min(k.row0 + r, g.n - 1);
        cp_async16(adst + r * LDB + 4 * q, a + static_cast<size_t>(gr) * d + ch * KC + 4 * q);
      }
    }
  };
  if (steps > 0) load_tile(0);
  cp_async_commit();
  if (steps > 1) load_tile(1);
  cp_async_commit();

  float a2r[8], v1[8], v2[8];
  int i1[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = k.row0 + ty + 16 * i;
    a2r[i] = gr < g.n ? k.a2m[gr] : BIG;
    v1[i] = __int_as_float(0x7f800000);  // +inf: no column seen yet
    v2[i] = BIG;
    i1[i] = NO_INDEX;
  }
  float acc[8][8];

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    if (s + 2 < steps) load_tile(s + 2);
    cp_async_commit();
    const int t = s / nch, ch = s - t * nch;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float* Bt = Bs + (s % STAGES) * BN * LDB;
    const float* At = DEEP ? As + (s % STAGES) * BQ * LDB : As + ch * KC;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * LDB + kk);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(At + (ty + 16 * i) * lda + kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
        }
      }
    }
    if (ch != nch - 1) continue;

    // Epilogue of tile t: row top-2 (columns in increasing order), then
    // the column candidates.
    const int c0 = k.col_begin + k.tile(t) * BN;
    float bm[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = c0 + tx + 16 * j;
      bm[j] = gc < k.col_end ? k.b2m[gc] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] *= g.scale;
      if (gc < k.col_end) {
#pragma unroll
        for (int i = 0; i < 8; ++i) push_top2(v1[i], i1[i], v2[i], acc[i][j] + bm[j], gc);
      }
    }
    if (g.do_col) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float best = __int_as_float(0x7f800000);
        int brow = NO_INDEX;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int gr = k.row0 + ty + 16 * i;
          const float sc = COL == COL_INDEX ? acc[i][j] + a2r[i] : (acc[i][j] + bm[j]) + a2r[i];
          if (gr < g.n && sc < best) {
            best = sc;
            brow = gr;
          }
        }
        take_lower(best, brow, __shfl_xor_sync(0xffffffffu, best, 16),
                   __shfl_xor_sync(0xffffffffu, brow, 16));
        if ((tid & 16) == 0) {
          cs.v[warp][tx + 16 * j] = best;
          cs.r[warp][tx + 16 * j] = brow;
        }
      }
      commit_columns<COL>(cs, c0, k.col_end, k.col_key);
    }
  }

  cp_async_wait<0>();  // nothing in flight when the block ends
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) merge_lanes(v1[i], i1[i], v2[i], off);
    const int gr = k.row0 + ty + 16 * i;
    if (tx == 0 && gr < g.n) {
      g.part_v1[k.part + gr] = v1[i];
      g.part_i1[k.part + gr] = i1[i];
      g.part_v2[k.part + gr] = v2[i];
    }
  }
}

// ---------------------------------------------------------------------------
// MODE_BF16 and MODE_BINARY: wgmma on the tensor cores.

// Stage `c16` 16-byte chunks, from value e0 on, of `rows` bf16 rows (r0 ..,
// clamped below `limit`; 2 d bytes a row) into the swizzled layout.
__device__ __forceinline__ void copy_bf16_chunk(unsigned char* dst, const unsigned char* src,
                                                 int r0, int rows, int limit, int d, int e0,
                                                 int c16) {
  for (int c = threadIdx.x; c < rows * c16; c += THREADS) {
    const int r = c / c16, q = c - r * c16;
    const int gr = min(r0 + r, limit - 1);
    cp_async16(dst + sw128_offset(r, q, rows),
               src + static_cast<size_t>(gr) * 2 * d + 2 * e0 + 16 * q);
  }
}

// Stage one bank tile (rows c0 .. c0 + BN - 1, clamped to the bank) of
// bf16 rows into the swizzled layout; 2 d bytes a row.
__device__ __forceinline__ void copy_bf16_tile(unsigned char* dst, const unsigned char* src,
                                                int r0, int rows, int limit, int d) {
  copy_bf16_chunk(dst, src, r0, rows, limit, d, 0, d / 8);
}

// Stage words w0 .. w0 + cw - 1 of `rows` packed rows (r0 .., clamped below
// `limit`; row stride w words) into a row-major tile of `dw` words a row.
__device__ __forceinline__ void copy_packed_chunk(uint32_t* dst, const uint32_t* src, int r0,
                                                   int rows, int limit, int w, int w0,
                                                   int cw, int dw) {
  const int c16 = cw / 4;
  for (int c = threadIdx.x; c < rows * c16; c += THREADS) {
    const int r = c / c16, q = c - r * c16;
    const int gr = min(r0 + r, limit - 1);
    cp_async16(dst + r * dw + 4 * q, src + static_cast<size_t>(gr) * w + w0 + 4 * q);
  }
}

// Stage packed words of a bank tile (BN rows x W words, row-major).
__device__ __forceinline__ void copy_packed(uint32_t* dst, const uint32_t* src, int r0,
                                             int rows, int limit, int w) {
  copy_packed_chunk(dst, src, r0, rows, limit, w, 0, w, w);
}

// Unpack words w0 .. w0 + cw - 1 of `rows` packed rows (row stride w
// words) into the swizzled +-1 layout, 32 bytes a word.
__device__ __forceinline__ void unpack_rows(unsigned char* dst, const uint32_t* src, int rows,
                                            int w, int w0, int cw) {
  for (int c = threadIdx.x; c < rows * cw * 2; c += THREADS) {
    const int r = c / (2 * cw), q = c - r * 2 * cw;  // q: 16-byte chunk of the row
    const uint32_t word = src[r * w + w0 + (q >> 1)];
    *reinterpret_cast<uint4*>(dst + sw128_offset(r, q, rows)) = unpack16(word, q & 1);
  }
}

// The tensor-core modes put the bank tile on wgmma's M side (64 rows,
// shared by both warpgroups) and each warpgroup's 64 queries on its N
// side, so that a thread's accumulator fragment holds 2 bank rows x 16
// queries: the per-bank-row reduction over queries runs in registers and
// over the 4 lanes of a quad, and each thread keeps the running top-2 of
// its 16 queries across the whole sweep (merged across lanes and warps
// once, at the end). Each bank tile costs one block-wide barrier: the
// barrier that makes tile t's stage visible also frees the stage the
// next load overwrites (read by tile t - 1's wgmma, waited for).
template <int MODE, int COL, bool DEEP>
__device__ __forceinline__ void wgmma_tiles(const TileArgs& g, const Block& k,
                                            unsigned char* smem_raw, ColumnScratch& cs) {
  using Acc = typename std::conditional<MODE == MODE_BF16, float, int>::type;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31, q = lane & 3;
  const int d = g.d;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  // Binary banks of more than CHUNK_WORDS words run depth chunk by chunk.
  const bool chunked = MODE == MODE_BINARY && d > CHUNK_WORDS;
  const int cw = MODE == MODE_BINARY ? min(d, CHUNK_WORDS) : 0;
  const int panel = 128 * panels_of(MODE == MODE_BF16 ? 2 * d : 32 * cw);  // bytes a tile row
  unsigned char* As = base;             // queries, BQ rows
  unsigned char* Bs = As + BQ * panel;  // bank tiles, BNW rows each
  const int b_stages = MODE == MODE_BF16 ? WSTAGES : chunked ? 1 : 2;
  uint32_t* Bpk = reinterpret_cast<uint32_t*>(Bs + b_stages * BNW * panel);  // chunked only
  uint32_t* Apk = Bpk + WSTAGES * BNW * d;
  const size_t row_bytes = MODE == MODE_BF16 ? 2 * d : 4 * d;
  const unsigned char* a = static_cast<const unsigned char*>(g.a) +
                           static_cast<size_t>(k.p) * g.n * row_bytes;
  const unsigned char* b = static_cast<const unsigned char*>(g.b) +
                           static_cast<size_t>(k.p) * g.m * row_bytes;
  const uint32_t* aw = reinterpret_cast<const uint32_t*>(a);
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(b);
  const int ntiles = k.ntiles;
  auto tile_row = [&](int t) { return k.col_begin + k.tile(t) * BNW; };

  // This thread's queries: row0 + 64 wg + 8 c + 2 q + e (16 of them, index
  // 2 c + e), and per tile the bank rows 16 (warp & 3) + lane / 4 + 8 h.
  const int qbase = k.row0 + wg * 64 + 2 * q;
  float v1[16], v2[16], a2x[16];
  int i1[16];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qi = qbase + 8 * c + e;
      // Queries past n carry +inf: they never win a bank row.
      a2x[2 * c + e] = qi < g.n ? k.a2m[qi] : __int_as_float(0x7f800000);
      v1[2 * c + e] = __int_as_float(0x7f800000);  // +inf: no bank row seen yet
      v2[2 * c + e] = BIG;
      i1[2 * c + e] = NO_INDEX;
    }
  }
  const int b_off = wg * 64 * 128;  // this warpgroup's 64 queries in each panel
  const int rlocal = (warp & 3) * 16 + (lane >> 2);

  // wgmma over `steps` 32-byte depth steps of the bank stage Bt and the
  // query tile At.
  auto mma = [&](Acc* acc, const unsigned char* Bt, int steps, const unsigned char* At) {
    fence_operands<32>(acc);
    wgmma_fence();
    for (int ks = 0; ks < steps; ++ks) {
      const int off = (ks & 3) * 32;
      const uint64_t da = sw128_desc(Bt + (ks >> 2) * BNW * 128 + off);
      const uint64_t db = sw128_desc(At + (ks >> 2) * BQ * 128 + b_off + off);
      if constexpr (MODE == MODE_BF16) {
        mma_bf16(acc, da, db, 1);
      } else {
        mma_s8(acc, da, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands<32>(acc);
  };

  // Epilogue of the tile at bank row c0. Bank rows: h = 0 then h = 1, in
  // increasing order for every query; queries in increasing order for
  // every bank row.
  auto epilogue = [&](const Acc* acc, int c0) {
    int brow[2];
    bool live[2];
    float bm[2], best[2];
    int bq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      brow[h] = c0 + rlocal + 8 * h;
      live[h] = brow[h] < k.col_end;
      bm[h] = live[h] ? __ldg(k.b2m + brow[h]) : 0.f;
      best[h] = __int_as_float(0x7f800000);
      bq[h] = NO_INDEX;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * c + e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // scale * x + bias in one rounding, exact as two (scale is -2
          // or 1); binary: x = dot, exact in float (|dot| < 2^22), with
          // the -2 folded into the scale.
          float x;
          if constexpr (MODE == MODE_BF16) {
            x = acc[4 * c + 2 * h + e];
          } else {
            x = int_to_float(acc[4 * c + 2 * h + e]);
          }
          const float xs = MODE == MODE_BF16 ? g.scale : -2.0f * g.scale;
          const float sr = fmaf(x, xs, bm[h]);
          if (live[h]) push_top2(v1[j], i1[j], v2[j], sr, brow[h]);
          if constexpr (COL == COL_INDEX) {
            const float sc = fmaf(x, xs, a2x[j]);
            if (sc < best[h]) {
              best[h] = sc;
              bq[h] = qbase + 8 * c + e;
            }
          } else {
            best[h] = fminf(best[h], sr + a2x[j]);
          }
        }
      }
    }
    if (g.do_col) {
      // Over the quad's 4 lanes (the warpgroup's 64 queries), then one
      // atomic per bank row and warpgroup.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best[h], off);
          if constexpr (COL == COL_INDEX) {
            take_lower(best[h], bq[h], ov, __shfl_xor_sync(0xffffffffu, bq[h], off));
          } else {
            best[h] = fminf(best[h], ov);
          }
        }
        const bool has = COL == COL_INDEX ? bq[h] != NO_INDEX
                                          : best[h] < __int_as_float(0x7f800000);
        if (q == 0 && live[h] && has) {
          const unsigned long long key =
              (static_cast<unsigned long long>(order_bits(best[h])) << 32) |
              (COL == COL_INDEX ? static_cast<unsigned int>(bq[h]) : 0u);
          atomicMin(k.col_key + brow[h], key);
        }
      }
    }
  };

  if constexpr (MODE == MODE_BF16 && DEEP) {
    // The depth loop: a ring of WSTAGES stages, each one 64-deep panel of
    // a bank tile and of the query tile, filled WSTAGES - 1 steps ahead; a
    // step is one (tile, chunk), the tile's sums stay in acc across chunks.
    constexpr int STAGE = (BNW + BQ) * 128;
    const int nch = (d + KCH - 1) / KCH;
    const int steps = ntiles * nch;
    auto load_step = [&](int s) {
      const int t = s / nch, ch = s - t * nch;
      const int c16 = min(KCH, d - ch * KCH) / 8;
      unsigned char* dst = base + (s % WSTAGES) * STAGE;
      copy_bf16_chunk(dst, b, tile_row(t), BNW, g.m, d, ch * KCH, c16);
      copy_bf16_chunk(dst + BNW * 128, a, k.row0, BQ, g.n, d, ch * KCH, c16);
    };
    for (int s = 0; s < WSTAGES - 1; ++s) {
      if (s < steps) load_step(s);
      cp_async_commit();
    }
    float acc[32];
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<WSTAGES - 2>();  // step s landed
      fence_async_smem();
      __syncthreads();
      if (s + WSTAGES - 1 < steps) load_step(s + WSTAGES - 1);  // the stage step s - 1 held
      cp_async_commit();
      const int t = s / nch, ch = s - t * nch;
      if (ch == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      }
      const unsigned char* st = base + (s % WSTAGES) * STAGE;
      mma(acc, st, min(KCH, d - ch * KCH) / 16, st + BNW * 128);
      if (ch == nch - 1) epilogue(acc, tile_row(t));
    }
    cp_async_wait<0>();  // nothing in flight when the block ends
  } else if constexpr (MODE == MODE_BF16) {
    // A ring of WSTAGES bank tiles, filled WSTAGES - 1 tiles ahead; the
    // queries travel with tile 0.
    auto load_tile = [&](int t) {
      copy_bf16_tile(Bs + (t % WSTAGES) * BNW * panel, b, tile_row(t), BNW, g.m, d);
    };
    copy_bf16_tile(As, a, k.row0, BQ, g.n, d);
    for (int t = 0; t < WSTAGES - 1; ++t) {
      if (t < ntiles) load_tile(t);
      cp_async_commit();
    }
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<WSTAGES - 2>();  // tile t landed
      fence_async_smem();
      __syncthreads();
      if (t + WSTAGES - 1 < ntiles) load_tile(t + WSTAGES - 1);  // the stage tile t - 1 held
      cp_async_commit();
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      mma(acc, Bs + (t % WSTAGES) * BNW * panel, d / 16, As);
      epilogue(acc, tile_row(t));
    }
    cp_async_wait<0>();  // nothing in flight when the block ends
  } else if (!chunked) {
    // Up to CHUNK_WORDS words: the queries unpack once; each bank tile's
    // words load into registers a tile ahead and unpack into one of two
    // +-1 stages after the previous tile's epilogue.
    for (int c = tid; c < BQ * cw * 2; c += THREADS) {
      const int r = c / (2 * cw), qq = c - r * 2 * cw;
      const int gr = min(k.row0 + r, g.n - 1);
      const uint32_t word = __ldg(aw + static_cast<size_t>(gr) * d + (qq >> 1));
      *reinterpret_cast<uint4*>(As + sw128_offset(r, qq, BQ)) = unpack16(word, qq & 1);
    }
    const int quads = cw / 4;                   // 16-byte word groups a row
    const bool loader = tid < BNW * quads;      // one group per loading thread
    const int lr = loader ? tid / quads : 0, lq = loader ? tid - lr * quads : 0;
    auto fetch = [&](int t) {
      const int gr = min(tile_row(t) + lr, g.m - 1);
      return __ldg(reinterpret_cast<const uint4*>(bw + static_cast<size_t>(gr) * d) + lq);
    };
    auto store = [&](uint4 w4, int stage) {
      unsigned char* dst = Bs + stage * BNW * panel;
      const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c16 = 2 * (4 * lq + i);
        *reinterpret_cast<uint4*>(dst + sw128_offset(lr, c16, BNW)) = unpack16(w[i], 0);
        *reinterpret_cast<uint4*>(dst + sw128_offset(lr, c16 + 1, BNW)) = unpack16(w[i], 1);
      }
    };
    uint4 pk = make_uint4(0u, 0u, 0u, 0u);
    if (loader && ntiles > 0) store(fetch(0), 0);
    fence_async_smem();
    __syncthreads();
    for (int t = 0; t < ntiles; ++t) {
      if (loader && t + 1 < ntiles) pk = fetch(t + 1);  // in flight during this tile
      int acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0;
      mma(acc, Bs + (t & 1) * BNW * panel, cw, As);
      epilogue(acc, tile_row(t));
      if (loader && t + 1 < ntiles) store(pk, (t + 1) & 1);  // read by tile t - 1, done
      fence_async_smem();
      __syncthreads();
    }
  } else if constexpr (DEEP) {
    // The depth loop: a ring of WSTAGES stages, each the packed words of
    // one depth chunk of a bank tile and of the query tile, unpacked to +-1
    // at their step; a step is one (tile, chunk).
    constexpr int STAGE_WORDS = (BNW + BQ) * CHUNK_WORDS;
    uint32_t* ring = Bpk;
    const int nch = (d + CHUNK_WORDS - 1) / CHUNK_WORDS;
    const int steps = ntiles * nch;
    auto load_step = [&](int s) {
      const int t = s / nch, w0 = (s - t * nch) * CHUNK_WORDS;
      const int n_w = min(CHUNK_WORDS, d - w0);
      uint32_t* dst = ring + (s % WSTAGES) * STAGE_WORDS;
      copy_packed_chunk(dst, bw, tile_row(t), BNW, g.m, d, w0, n_w, CHUNK_WORDS);
      copy_packed_chunk(dst + BNW * CHUNK_WORDS, aw, k.row0, BQ, g.n, d, w0, n_w, CHUNK_WORDS);
    };
    for (int s = 0; s < WSTAGES - 1; ++s) {
      if (s < steps) load_step(s);
      cp_async_commit();
    }
    int acc[32];
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<WSTAGES - 2>();
      __syncthreads();  // step s landed; the stage step s - 1 held is free
      if (s + WSTAGES - 1 < steps) load_step(s + WSTAGES - 1);
      cp_async_commit();
      const int t = s / nch, ch = s - t * nch;
      const int n_w = min(CHUNK_WORDS, d - ch * CHUNK_WORDS);
      const uint32_t* st = ring + (s % WSTAGES) * STAGE_WORDS;
      unpack_rows(As, st + BNW * CHUNK_WORDS, BQ, CHUNK_WORDS, 0, n_w);
      unpack_rows(Bs, st, BNW, CHUNK_WORDS, 0, n_w);
      fence_async_smem();
      __syncthreads();
      if (ch == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0;
      }
      mma(acc, Bs, n_w, As);
      __syncthreads();  // the +-1 chunks may be overwritten
      if (ch == nch - 1) epilogue(acc, tile_row(t));
    }
    cp_async_wait<0>();
  } else {
    // More words: packed queries and a packed ring of bank tiles in shared
    // memory, unpacked one depth chunk at a time.
    auto load_tile = [&](int t) {
      copy_packed(Bpk + (t % WSTAGES) * BNW * d, bw, tile_row(t), BNW, g.m, d);
    };
    copy_packed(Apk, aw, k.row0, BQ, g.n, d);
    for (int t = 0; t < WSTAGES - 1; ++t) {
      if (t < ntiles) load_tile(t);
      cp_async_commit();
    }
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<WSTAGES - 2>();
      __syncthreads();  // packed tile t landed; the stage tile t - 1 held is free
      if (t + WSTAGES - 1 < ntiles) load_tile(t + WSTAGES - 1);
      cp_async_commit();
      const uint32_t* Bp = Bpk + (t % WSTAGES) * BNW * d;
      int acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0;
      for (int w0 = 0; w0 < d; w0 += CHUNK_WORDS) {
        const int n_w = min(CHUNK_WORDS, d - w0);
        unpack_rows(As, Apk, BQ, d, w0, n_w);
        unpack_rows(Bs, Bp, BNW, d, w0, n_w);
        fence_async_smem();
        __syncthreads();
        mma(acc, Bs, n_w, As);
        __syncthreads();  // the +-1 chunks may be overwritten
      }
      epilogue(acc, tile_row(t));
    }
    cp_async_wait<0>();
  }

  // Merge each query's top-2 over the 8 lanes that share q (their bank
  // rows), then over the warpgroup's 4 warps through shared memory.
  float* mv1 = &cs.v[0][0];
  float* mv2 = mv1 + WARPS * 64;
  int* mi1 = &cs.r[0][0];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) merge_lanes(v1[j], i1[j], v2[j], off);
    if (lane < 4) {
      const int o = warp * 64 + 8 * (j >> 1) + 2 * q + (j & 1);
      mv1[o] = v1[j];
      mi1[o] = i1[j];
      mv2[o] = v2[j];
    }
  }
  __syncthreads();
  if (tid < BQ) {
    const int w0 = (tid >> 6) * 4, col = tid & 63;
    float r1 = mv1[w0 * 64 + col], r2 = mv2[w0 * 64 + col];
    int ri = mi1[w0 * 64 + col];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      const int o = (w0 + w) * 64 + col;
      merge_top2(r1, ri, r2, mv1[o], mi1[o], mv2[o]);
    }
    const int gr = k.row0 + tid;
    if (gr < g.n) {
      g.part_v1[k.part + gr] = r1;
      g.part_i1[k.part + gr] = ri;
      g.part_v2[k.part + gr] = r2;
    }
  }
}

// ---------------------------------------------------------------------------
// Dead bank tiles. Where every bank row of a tile is dead (b2m = BIG), each
// of its candidates is s + BIG, which rounds to BIG exactly while |s| <
// half an ulp of BIG (~1e31): it can neither be a query's best nor lower
// its runner-up (which starts at BIG), as long as the pair has a live row
// (whose candidate is then below BIG). A block skips such tiles when the
// pair has a live row and every unmasked squared norm it meets (its
// queries, the pair's bank rows) is below SKIP_NORM_LIMIT = 1e30, which
// bounds |s| by 2e30. The skipped tiles' bank rows then get no column key:
// K1 reads a key only at a query's best row, which is live. K2, whose nnb
// covers dead rows too, never skips.

constexpr float SKIP_NORM_LIMIT = 1e30f;
constexpr int MAX_LISTED_TILES = 64;

struct LiveTiles {
  unsigned long long mask;
  unsigned char ids[MAX_LISTED_TILES];
};

template <int TILE>
__device__ void plan_live_tiles(const TileArgs& g, Block& k, LiveTiles& lt) {
  const int tid = threadIdx.x;
  if (tid == 0) lt.mask = 0ull;
  __syncthreads();
  bool any = false, small = true;
  unsigned long long mine = 0ull;
  const float* b2raw = g.b2raw ? g.b2raw + static_cast<size_t>(k.p) * g.m : nullptr;
  for (int r = tid; r < g.m; r += THREADS) {
    const bool lv = k.b2m[r] < BIG;
    any |= lv;
    if (b2raw) small &= b2raw[r] < SKIP_NORM_LIMIT;
    if (lv && r >= k.col_begin && r < k.col_end) mine |= 1ull << ((r - k.col_begin) / TILE);
  }
  if (g.a2raw && tid < BQ && k.row0 + tid < g.n) {
    small &= g.a2raw[static_cast<size_t>(k.p) * g.n + k.row0 + tid] < SKIP_NORM_LIMIT;
  }
  const unsigned int lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned int>(mine));
  const unsigned int hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned int>(mine >> 32));
  if ((tid & 31) == 0 && (lo | hi)) {
    atomicOr(&lt.mask, (static_cast<unsigned long long>(hi) << 32) | lo);
  }
  const int pair_live = __syncthreads_or(any);
  const int bounded = __syncthreads_and(small);
  if (!pair_live || !bounded) return;
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < k.ntiles; ++t)
      if ((lt.mask >> t) & 1ull) lt.ids[n++] = static_cast<unsigned char>(t);
  }
  __syncthreads();
  k.ntiles = __popcll(lt.mask);
  k.tile_ids = lt.ids;
}

// ---------------------------------------------------------------------------
// The kernel: grid (query tiles, splits, pairs).

// Exact mode holds an 8 x 8 tile a thread (one block an SM); the tensor-core
// modes fit two blocks an SM (at most 128 registers a thread).
template <int MODE, int COL, bool DEEP>
__global__ void __launch_bounds__(THREADS, MODE == MODE_EXACT ? 1 : 2)
    match_tiles(const TileArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ ColumnScratch cs;
  __shared__ LiveTiles tiles;
  Block k;
  k.p = blockIdx.z;
  k.row0 = blockIdx.x * BQ;
  k.col_begin = blockIdx.y * g.cols_per_split;
  k.col_end = min(g.m, k.col_begin + g.cols_per_split);
  k.a2m = g.a2m + static_cast<size_t>(k.p) * g.n;
  k.b2m = g.b2m + static_cast<size_t>(k.p) * g.m;
  k.col_key = g.col_key + static_cast<size_t>(k.p) * g.m;
  k.part = (static_cast<size_t>(blockIdx.y) * g.pairs + k.p) * g.n;
  constexpr int TILE = MODE == MODE_EXACT ? BN : BNW;
  k.ntiles = (k.col_end - k.col_begin + TILE - 1) / TILE;
  k.tile_ids = nullptr;
  if (g.skip_dead && k.ntiles <= MAX_LISTED_TILES) {
    plan_live_tiles<TILE>(g, k, tiles);
  }
  if constexpr (MODE == MODE_EXACT) {
    simt_tiles<COL, DEEP>(g, k, smem_raw, cs);
  } else {
    wgmma_tiles<MODE, COL, DEEP>(g, k, smem_raw, cs);
  }
}

// Launch over (query tiles, splits, pairs). The shared-memory limit is
// raised once per instantiation and device, to what the largest depth
// needs (the depth loop's layout does not grow with the depth); each
// launch asks for what its own depth needs.
template <int MODE, int COL, bool DEEP>
cudaError_t launch_depth(const TileArgs& g, int splits, cudaStream_t s) {
  static unsigned int configured = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(configured & (1u << (dev & 31)))) {
    const int deepest = DEEP ? g.d : MODE == MODE_BINARY ? RESIDENT_WORDS : RESIDENT_DIM;
    err = cudaFuncSetAttribute(match_tiles<MODE, COL, DEEP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(MODE, deepest)));
    if (err != cudaSuccess) return err;
    configured |= 1u << (dev & 31);
  }
  const dim3 grid((g.n + BQ - 1) / BQ, splits, g.pairs);
  match_tiles<MODE, COL, DEEP><<<grid, THREADS, smem_bytes(MODE, g.d), s>>>(g);
  return cudaGetLastError();
}

template <int MODE, int COL>
cudaError_t launch_tiles(const TileArgs& g, int splits, cudaStream_t s) {
  return deep_of(MODE, g.d) ? launch_depth<MODE, COL, true>(g, splits, s)
                            : launch_depth<MODE, COL, false>(g, splits, s);
}

}  // namespace
}  // namespace fm
