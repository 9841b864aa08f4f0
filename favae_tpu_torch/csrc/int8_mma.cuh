// The int8 weight-streaming product on the tensor cores: a few bf16 rows of
// activations times a chunk of an int8 (K, N) weight matrix, f32 sums.
//
// Same contract as int8_common.cuh::tile_mac_reduce (an item's rows x columns
// x chunk of K -> an f32 partial that the caller adds to the other chunks in
// ascending order), designed for the card instead of the CUDA cores:
//   * Bytes in flight. The item's weight rows go through a ring of STAGES
//     shared-memory buffers of 64 rows x 128 columns (8 KB). A buffer is
//     filled by one TMA request (cp.async.bulk.tensor.2d through a tensor
//     map of the weight matrix) that reports to the buffer's mbarrier; one
//     thread asks, nobody spends registers or address arithmetic on the
//     copy, rows past K and columns past N arrive as zeros. All STAGES
//     requests are in flight before the first product: 40 KB a block, and
//     several blocks share an SM. The same ring in 16-byte cp.async pieces
//     streamed at 11-14 GB/s an SM on an H100 whatever the blocks on it: an
//     SM keeps too few 16-byte requests in flight. The activations of the
//     item (bf16, a few KB, once a block) do come by cp.async.
//   * Products on the tensor cores, transposed: out^T = W^T x^T, so that the
//     weight tile is the 16-row operand of mma.sync m16n8k16 (bf16 x bf16 ->
//     f32) and the 8 activation rows are its n = 8 side with no padding. A
//     second group of 8 rows (NB = 2) reuses the converted weights.
//   * No transposing loads. Which column of the tile sits in which row of
//     the 16-row operand is free, so a thread reads four 32-bit words (the
//     four k-rows its fragment wants, four neighbouring columns each) and
//     has both weight fragments of two instructions; its activation
//     fragment is two 32-bit loads of a row as it lies in memory.
//   * int8 -> bf16 is exact (|q| <= 127): through the exponent trick to f32
//     (int8_common.cuh::dequant4), then the upper halves of two values in
//     one byte permute. Products
//     are exact; only the order of the f32 sum differs from the plain
//     PyTorch version.
//   * No bank conflicts: TMA writes the 128-byte rows with its 128-byte
//     swizzle (the 16-byte piece p of row r lands at piece p ^ (r % 8)), so
//     the rows 2 t of a quad fall on four different pairs of pieces; an
//     activation row has a word stride of 4 mod 32.
// The sum is deterministic: k-steps in ascending order inside a warp, even
// and odd steps in two accumulators added at the end, and no other warp
// shares a column.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace favae {
namespace mma8 {

constexpr int TN = 128;      // columns of an item: 4 warps x 32
constexpr int WARPS = TN / 32;
constexpr int THREADS = 32 * WARPS;
constexpr int SK = 64;       // weight rows in one stage of the ring
constexpr int STEPS = SK / 16;  // k-steps of 16 rows in a stage
constexpr int STAGES = 5;    // ring depth, all of it in flight at the start
constexpr int STAGE_BYTES = SK * TN;
constexpr int RING_ALIGN = 1024;  // the swizzle repeats every 8 rows

// Row stride (in bf16) of the activations in shared memory for a chunk of kc
// (a multiple of 16): the next count with a word stride of 4 mod 32.
__host__ __device__ inline int x_stride(int kc) {
  return kc + ((8 - kc % 64) + 64) % 64;
}

// 16 bytes global -> shared: the first n (0 to 16) from src, zeros after.
__device__ __forceinline__ void copy16(void* dst, const void* src, int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Two floats of at most 8 significant bits (dequantised int8) as bf16x2:
// their upper halves, exactly, in one byte permute (a cvt runs at a fraction
// of its rate).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Once a block, by one thread, before the block's next __syncthreads().
__device__ __forceinline__ void init_barriers(uint64_t* bars) {
  for (int i = 0; i < STAGES; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     shared_address(&bars[i]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Spin until the phase of `parity` of the mbarrier has completed; a copy
// that never arrives traps instead of hanging the card.
__device__ __forceinline__ void wait_barrier(uint64_t* bar, int parity) {
  uint32_t done;
  for (int spins = 0;; ++spins) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(shared_address(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1 << 26)) __trap();
  }
}

// Stage `s` of the item's weights, asked for by the calling thread alone:
// rows k0 + s SK .. + SK - 1, columns col0 .. col0 + TN - 1 of the matrix
// behind `wmap`, zeros outside it.
__device__ __forceinline__ void issue_stage(uint8_t* ring, uint64_t* bars,
                                            int s, const CUtensorMap* wmap,
                                            int k0, int col0) {
  const uint32_t bar = shared_address(&bars[s % STAGES]);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(STAGE_BYTES)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(
          shared_address(ring + (s % STAGES) * STAGE_BYTES)),
      "l"(reinterpret_cast<uint64_t>(wmap)), "r"(bar), "r"(col0),
      "r"(k0 + s * SK)
      : "memory");
}

// Stage `s` of an item of layer `layer` of an (L, K, N) int8 weight stack,
// asked for by the calling thread alone: rows k + s SK .. + SK - 1, columns
// col0 .. + TN - 1 of that layer through a 3-D tensor map (N, K, L), so rows
// past K arrive as zeros instead of the next layer's, into `dst` (STAGE_BYTES
// at a RING_ALIGN boundary), reporting to `bar`. The proxy fence orders the
// block's earlier generic reads of `dst` before the copy overwrites it.
__device__ __forceinline__ void issue_box3(uint8_t* dst, uint64_t* bar,
                                           const CUtensorMap* wmap, int col0,
                                           int k, int layer) {
  const uint32_t b = shared_address(bar);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
               "r"(STAGE_BYTES)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(shared_address(dst)),
      "l"(reinterpret_cast<uint64_t>(wmap)), "r"(b), "r"(col0), "r"(k),
      "r"(layer)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// CUDA's cuTensorMapEncodeTiled, looked up once through the runtime
// (the libraries link no stub of libcuda); null where CUDA gives none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// An int8 weight tensor of `dims` (innermost first: N, K[, L]) with rows of
// N bytes, cut into boxes of SK rows x TN columns (one layer) written with
// the 128-byte swizzle, zeros outside the tensor.
inline bool weight_map(CUtensorMap* map, const void* wq, int rank,
                       const cuuint64_t* dims) {
  const cuuint64_t strides[2] = {dims[0], dims[0] * dims[1]};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)TN, (cuuint32_t)SK, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode_tiled() != nullptr &&
         encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                        const_cast<void*>(wq), dims, strides, box, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Activations of the item into shared memory: xs[m][k - k0] = x[r0 + m][k]
// for k in [k0, k1) and m < rows_valid, zero up to the chunk's padded length
// and for the other rows. Asynchronous 16-byte copies where x allows them
// (rows 16-byte aligned), plain loads otherwise; either way complete for the
// block after wait_copies + __syncthreads.
// `tid` of `nthreads` threads fill.
template <int NB>
__device__ __forceinline__ void fill_x(__nv_bfloat16* xs, int ldx,
                                       const __nv_bfloat16* __restrict__ x,
                                       int ldg, int r0, int rows_valid, int k0,
                                       int k1, int kc_pad, int tid,
                                       int nthreads) {
  if (ldg % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int pieces = kc_pad / 8;  // k0 is a multiple of 16
    for (int i = tid; i < 8 * NB * pieces; i += nthreads) {
      const int m = i / pieces, kk = i % pieces * 8;
      const int left = m < rows_valid ? min(max(k1 - k0 - kk, 0), 8) : 0;
      copy16(xs + m * ldx + kk,
             left ? x + (size_t)(r0 + m) * ldg + k0 + kk : x, 2 * left);
    }
  } else {
    for (int i = tid; i < 8 * NB * kc_pad; i += nthreads) {
      const int m = i / kc_pad, kk = i % kc_pad;
      const bool valid = m < rows_valid && k0 + kk < k1;
      xs[m * ldx + kk] =
          valid ? x[(size_t)(r0 + m) * ldg + k0 + kk] : __float2bfloat16(0.f);
    }
  }
  commit_copies();
}

// The products of one landed stage (SK weight rows x TN columns at `buf`,
// as TMA wrote it with the 128-byte swizzle) with the activations
// xs[m][koff .. koff + SK) (row stride ldx), added into acc[step parity][row
// group][column pair] of warp `warp` (0 to 3), which owns columns
// 32 warp .. + 31 of the tile.
template <int NB>
__device__ __forceinline__ void stage_products(const uint8_t* buf,
                                               const __nv_bfloat16* xs, int ldx,
                                               int koff, int warp, int lane,
                                               float (&acc)[2][NB][2][4]) {
  const int g = lane >> 2, t = lane & 3;
  // a thread's word of a weight row: columns 32 warp + 4 g .. + 3, that is
  // piece 2 warp + g / 4, word g % 4 of it
  const int piece = 2 * warp + (g >> 2), word = (g & 3) * 4;
  // The stage's k-steps of 16 rows. A warp runs in order, so all of the
  // stage's shared loads start before the first conversion; even and odd
  // steps add into separate accumulators.
  uint32_t wv[STEPS][4], xv[STEPS][NB][2];
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int kb = st * 16;
    // the k-rows of the fragment: 2 t, 2 t + 1, 2 t + 8, 2 t + 9
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = kb + 2 * t + (j & 1) + 8 * (j >> 1);
      wv[st][j] = *reinterpret_cast<const uint32_t*>(
          buf + r * TN + ((piece ^ (r & 7)) << 4) + word);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(
          xs + (b * 8 + g) * ldx + koff + kb + 2 * t);
      xv[st][b][0] = row[0];
      xv[st][b][1] = row[4];
    }
  }
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    float f[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dequant4(wv[st][j], f[j]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // rows g and g + 8 of the 16-row operand: columns 4 g + 2 h, + 1
      const uint32_t a[4] = {pack_bf16(f[0][2 * h], f[1][2 * h]),
                             pack_bf16(f[0][2 * h + 1], f[1][2 * h + 1]),
                             pack_bf16(f[2][2 * h], f[3][2 * h]),
                             pack_bf16(f[2][2 * h + 1], f[3][2 * h + 1])};
#pragma unroll
      for (int b = 0; b < NB; ++b)
        mma_bf16(acc[st & 1][b][h], a, xv[st][b][0], xv[st][b][1]);
    }
  }
}

// The item's product, for a block of THREADS threads, every one of them
// calling: warp w owns columns col0 + 32 w .. + 31 of the tile. (Eight warps,
// two to a column group along k, were 0.4 to 1.6 us slower on an H100.) `ring` holds
// STAGES * STAGE_BYTES bytes aligned to RING_ALIGN, `bars` STAGES mbarriers
// (init_barriers, then a __syncthreads, before the call), `xs` 8 NB rows of
// x_stride(kc_pad) bf16, kc_pad = k1 - k0 rounded up to SK (0 for an empty
// chunk); k0 is a multiple of 16; `wmap` describes the (K, N) int8 matrix
// with a box of SK rows x TN columns and the 128-byte swizzle. Leaves the
// (8 NB, TN) f32 partial in `part` (shared memory, row stride TN) and the
// block synchronised.
template <int NB>
__device__ __forceinline__ void tile_mma(
    uint8_t* ring, uint64_t* bars, __nv_bfloat16* xs, float* part,
    const __nv_bfloat16* __restrict__ x, int ldg, int r0, int rows_valid,
    const CUtensorMap* wmap, int k0, int k1, int col0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kc = max(k1 - k0, 0);
  const int stages = (kc + SK - 1) / SK;
  const int kc_pad = stages * SK;  // zeros of x meet the rows past k1
  const int ldx = x_stride(kc_pad);

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(wmap))
                 : "memory");
    for (int s = 0; s < min(stages, STAGES); ++s)
      issue_stage(ring, bars, s, wmap, k0, col0);
  }
  fill_x<NB>(xs, ldx, x, ldg, r0, rows_valid, k0, k1, kc_pad,
             threadIdx.x, THREADS);
  wait_copies<0>();
  __syncthreads();  // the activations are whole

  // acc[step parity][row group][column pair]
  float acc[2][NB][2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][b][h][i] = 0.f;

  for (int s = 0; s < stages; ++s) {
    wait_barrier(&bars[s % STAGES], (s / STAGES) & 1);  // stage s has landed
    stage_products<NB>(ring + (s % STAGES) * STAGE_BYTES, xs, ldx, s * SK,
                       warp, lane, acc);
    if (s + STAGES < stages) {
      __syncthreads();  // stage s is consumed by every warp
      if (threadIdx.x == 0) issue_stage(ring, bars, s + STAGES, wmap, k0, col0);
    }
  }

  // acc[.][b][h] = {(col 4g+2h, row 2t), (4g+2h, 2t+1), (4g+2h+1, 2t),
  // (4g+2h+1, 2t+1)} of row group b
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float4*>(
          &part[(b * 8 + 2 * t + r) * TN + warp * 32 + g * 4]) =
          make_float4(acc[0][b][0][r] + acc[1][b][0][r],
                      acc[0][b][0][2 + r] + acc[1][b][0][2 + r],
                      acc[0][b][1][r] + acc[1][b][1][r],
                      acc[0][b][1][2 + r] + acc[1][b][1][2 + r]);
  __syncthreads();
}

}  // namespace mma8
}  // namespace favae
