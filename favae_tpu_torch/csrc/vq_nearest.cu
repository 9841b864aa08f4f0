// Nearest codebook entry per token: idx[n] = argmax_k (x[n] . e[k] + bias[k]).
//
// Replaces favae_tpu/ops/vq_pallas.py::vq_nearest_pallas (body
// _vq_argmax_kernel). The TPU kernel walks the codebook along a sequential
// grid axis and carries the running best in VMEM scratch; blocks on the card
// run in parallel and in no order, so nothing is carried between them here.
//
// Bound (celebahq_expe5, batch 16: N = 4096, K = 1024, D = 256): the 5 MB of
// inputs take 1.5 us at 3.35 TB/s, the 2 N K D = 2.1 GFLOP take 32 us as f32
// FMA on the CUDA cores (67 TFLOP/s): bound by operations, so the products go
// to the tensor cores. Their TF32 inputs keep 10 bits of mantissa, too few to
// tell near codes apart, so each product is error-compensated: x = x_hi +
// x_lo and e = e_hi + e_lo, `hi` the value rounded to TF32 and `lo` the
// remainder, and x_lo e_hi + x_hi e_lo + x_hi e_hi (small terms first) is
// summed in f32. That is three products at 495 TFLOP/s: 6 N K D operations,
// 13 us.
//
// Design:
//   * Block = BN = 128 tokens x BK = 128 codes at a time, two warpgroups of 64
//     tokens each. A loop walks the block's code tiles in ascending order
//     and, inside, depth chunks of BD = 64. Every chunk comes from L2, so
//     the tile is square: a block reads (BN + BK) D floats for BN BK scores.
//   * Products: wgmma m64n128k8 (TF32, f32 accumulation), the only way to
//     the card's TF32 rate (mma.sync m16n8k8 reached half of it: 27 us for
//     the three products alone). The x halves are the register operand,
//     split on the way from shared memory in integer instructions
//     (cvt.rna.tf32.f32 runs at a sixteenth of their rate). The e halves are
//     the shared-memory operand: a pass over the chunk rounds e to TF32 in
//     place and writes the remainders to a second buffer at the same
//     offsets, whatever the layout; the pass over the next chunk runs while
//     the tensor cores work on this one. The 24 products of a chunk are chained
//     in the tensor core and the chunk's sum is added to the f32 score by
//     the CUDA cores, which round to nearest where the tensor core's
//     accumulator cuts off (summed in the tensor core throughout, a chosen
//     code trailed the best by 1.2e-4 at the euclidean shape).
//   * Staging: two buffers, one chunk on its way while the other is
//     multiplied, each with an mbarrier. A chunk is four TMA boxes of 128
//     rows x 32 depths, two of x and two of e, through tensor maps of the two
//     matrices, written with the 128-byte swizzle that wgmma's descriptor
//     names and that spreads the x fragment loads of 8 rows x 4 depths over
//     32 banks (rows past N or K and depths past D arrive as zeros). One
//     thread asks. The same bytes in 16-byte cp.async pieces took 28 us for
//     the copies alone, in 256-byte bulk rows 19: an SM keeps too few small
//     requests in flight, and the 67 MB that the blocks read from L2 are
//     the kernel's second bound. Chunks of 32 depths in a ring of four were
//     slower (0.039 against 0.034 ms): every chunk costs a block barrier.
//     Inputs that are not 16-byte aligned (D % 4 != 0) are staged with plain
//     loads into the same layout, without the mbarriers.
//   * 32 token tiles (N = 4096) cannot fill 132 SMs, so the codebook is
//     split along gridDim.y until the blocks number one an SM. Each split
//     walks its run of code tiles and writes its best (score, index) per
//     token to scratch; the last block of a token tile to arrive (an integer
//     counter per tile that it sets back to zero) reads the splits in
//     ascending order, a strict '>' keeping the lowest index of a tie: one
//     launch, and the same answer whatever the order of arrival. (The splits
//     as a thread-block cluster, met through distributed shared memory, gave
//     the same answers 1.7 x slower on an H100: the card did not keep all the
//     clusters of 256-thread blocks resident at once.)
//   * A thread's running (best score, best index) of its 2 tokens stays in
//     registers across the code tiles; its codes come in ascending order, so
//     a strict '>' keeps the lowest index of a tie. At the end the four
//     threads of a quad, which share a token, meet through shuffles under
//     "higher score, or equal score and lower index". Codes k >= K (or past
//     the split) are masked, not padded.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;        // tokens per block: two warpgroups of 64
constexpr int BK = 128;        // codes per tile: the n of one wgmma
constexpr int BD = 64;         // depth of one staged chunk
constexpr int KB = 32;         // depths of a box: a swizzled row of 128 bytes
constexpr int NBOX = BD / KB;  // boxes of a chunk, for either matrix
constexpr int THREADS = 256;
constexpr int BOX_FLOATS = 128 * KB;             // 16 KB: 128 rows of a box
constexpr int HALF_FLOATS = NBOX * BOX_FLOATS;   // a chunk of one matrix
constexpr int STAGE_FLOATS = 3 * HALF_FLOATS;    // x, e (hi in place), e's lo
constexpr int STAGES = 2;
constexpr int ALIGN = 1024;    // the swizzle repeats every 8 rows of 128 bytes
constexpr int NO_CODE = 0x7fffffff;
constexpr int SMEM_BYTES = ALIGN + STAGES * STAGE_FLOATS * sizeof(float);

static_assert(BN == 128 && BK == 128, "a box holds 128 rows of either matrix");

__device__ __forceinline__ void take_better(float& s, int& k, float s2, int k2) {
  if (s2 > s || (s2 == s && k2 < k)) {
    s = s2;
    k = k2;
  }
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Where depth d of row r lies in a chunk of one matrix, in floats: box
// d / 32, rows of 128 bytes, the 16-byte piece p of row r at p ^ (r % 8)
// (TMA's 128-byte swizzle).
__device__ __forceinline__ int chunk_offset(int r, int d) {
  const int dd = d % KB;
  return d / KB * BOX_FLOATS + r * KB + (((dd >> 2) ^ (r & 7)) << 2) + (dd & 3);
}

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds), lo the exact remainder, of which the tensor core
// reads the leading 11 bits (an error of 2^-21 |v|).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d (+)= a . b^T for one warpgroup: a (64 x 8, the register fragment of
// mma m16n8k8 for each of its four warps), b 128 rows x 8 depths in shared
// memory behind `desc`, d 64 x 128 (d[i] of a thread: row 16 w + g +
// 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2). scale_d = 0 starts d
// from zero.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// wgmma's descriptor of a box of e at `p`: rows of 128 bytes, 128-byte
// swizzle, 1024 bytes from one group of 8 rows to the next.
__device__ __forceinline__ uint64_t box_descriptor(const float* p) {
  return (uint64_t)((shared_address(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// One chunk into its buffer: the boxes of x rows n0.. then those of e codes
// k0.., depths d0..d0+BD-1; zero outside [0, n_tok) x [0, n_code) x
// [0, depth). Aligned inputs: thread 0 arms `bar` with the chunk's bytes and
// asks for the boxes; the chunk is whole when the barrier's phase completes.
// Otherwise plain loads and stores by every thread, whole after the block's
// next __syncthreads().
__device__ __forceinline__ void stage_chunk(
    float* buf, uint64_t* bar, const float* __restrict__ x,
    const float* __restrict__ e, const CUtensorMap* xmap,
    const CUtensorMap* emap, int n0, int k0, int d0, int n_tok, int n_code,
    int depth, bool aligned) {
  if (aligned) {
    if (threadIdx.x != 0) return;
    const uint32_t b = shared_address(bar);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
                 "r"(2 * HALF_FLOATS * 4)
                 : "memory");
    for (int m = 0; m < 2 * NBOX; ++m)
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
          "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(
              shared_address(buf + m * BOX_FLOATS)),
          "l"(reinterpret_cast<uint64_t>(m < NBOX ? xmap : emap)), "r"(b),
          "r"(d0 + m % NBOX * KB), "r"(m < NBOX ? n0 : k0)
          : "memory");
    return;
  }
  for (int i = threadIdx.x; i < 2 * HALF_FLOATS; i += THREADS) {
    const bool tok = i < HALF_FLOATS;
    const int r = i % HALF_FLOATS / BD, d = i % BD;
    const int g = (tok ? n0 : k0) + r;
    const bool valid = g < (tok ? n_tok : n_code) && d0 + d < depth;
    buf[(tok ? 0 : HALF_FLOATS) + chunk_offset(r, d)] =
        valid ? (tok ? x : e)[(size_t)g * depth + d0 + d] : 0.f;
  }
}

// e = hi + lo for the chunk in `buf`, once it has landed: hi rounded to TF32
// in place, lo at the same offset of the stage's third part; then the fence
// that lets the tensor cores (the async proxy) see the stores after the
// block's next __syncthreads().
__device__ __forceinline__ void split_chunk(float* buf, uint64_t* bar,
                                            int parity, bool aligned) {
  if (aligned) wait_barrier(bar, parity);
  else __syncthreads();
  float* e_hi = buf + HALF_FLOATS;
  float* e_lo = e_hi + HALF_FLOATS;
  for (int i = threadIdx.x; i < HALF_FLOATS / 4; i += THREADS) {
    const float4 v = reinterpret_cast<const float4*>(e_hi)[i];
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    reinterpret_cast<uint4*>(e_hi)[i] = make_uint4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<uint4*>(e_lo)[i] = make_uint4(l[0], l[1], l[2], l[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
vq_argmax(const float* __restrict__ x, const float* __restrict__ e,
          const __grid_constant__ CUtensorMap xmap,
          const __grid_constant__ CUtensorMap emap,
          const float* __restrict__ bias, float* part_score, int* part_idx,
          int* arrived, int* __restrict__ out, int n_tok, int n_code,
          int depth, int tiles_per_split, int aligned) {
  extern __shared__ uint8_t smem[];
  __shared__ float red_s[BN];
  __shared__ int red_k[BN];
  __shared__ __align__(8) uint64_t bars[STAGES];
  __shared__ bool last;
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem) + ALIGN - 1) / ALIGN * ALIGN);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = 16 * warp + g;  // the thread's tokens: row and row + 8
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int k_begin = min(n_code, split * tiles_per_split * BK);
  const int k_end = min(n_code, k_begin + tiles_per_split * BK);
  const int chunks = (depth + BD - 1) / BD;
  const int tiles = (k_end - k_begin + BK - 1) / BK;
  const int steps = tiles * chunks;  // (code tile, depth chunk) in order

  float best[2];
  int best_k[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    best[i] = __int_as_float(0xff800000);  // -inf
    best_k[i] = NO_CODE;
  }

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       shared_address(&bars[i]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (steps > 0) {
    stage_chunk(ring, &bars[0], x, e, &xmap, &emap, n0, k_begin, 0, n_tok,
                n_code, depth, aligned);
    split_chunk(ring, &bars[0], 0, aligned);
  }

  float acc[64];
  for (int s = 0; s < steps; ++s) {
    const int k0 = k_begin + s / chunks * BK, chunk = s % chunks;
    const float* xs = ring + s % STAGES * STAGE_FLOATS;
    const float* e_hi = xs + HALF_FLOATS;
    const float* e_lo = e_hi + HALF_FLOATS;
    float* next = ring + (s + 1) % STAGES * STAGE_FLOATS;
    __syncthreads();  // chunk s's halves are whole; chunk s - 1 is consumed
    if (s + 1 < steps)
      stage_chunk(next, &bars[(s + 1) % STAGES], x, e, &xmap, &emap, n0,
                  k_begin + (s + 1) / chunks * BK, (s + 1) % chunks * BD,
                  n_tok, n_code, depth, aligned);

    // the x halves of the chunk: a[k8] the fragment of depths 8 k8 .. + 7
    uint32_t ahi[BD / 8][4], alo[BD / 8][4];
#pragma unroll
    for (int k8 = 0; k8 < BD / 8; ++k8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // row + 8 (i % 2), depth 8 k8 + t + 4 (i / 2)
        const float v =
            xs[chunk_offset(row + 8 * (i & 1), 8 * k8 + t + 4 * (i >> 1))];
        split_tf32(v, ahi[k8][i], alo[k8][i]);
      }
    }
    // the chunk's 24 products, small terms first within a depth step,
    // chained in the tensor core from zero
    float c[64];
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int k8 = 0; k8 < BD / 8; ++k8) {
      const int at = k8 / (KB / 8) * BOX_FLOATS;  // the box; + 2 is 8 depths on
      const uint64_t hi = box_descriptor(e_hi + at) + 2 * (k8 % (KB / 8));
      const uint64_t lo = box_descriptor(e_lo + at) + 2 * (k8 % (KB / 8));
      wgmma_tf32(c, alo[k8], hi, k8 > 0);
      wgmma_tf32(c, ahi[k8], lo, 1);
      wgmma_tf32(c, ahi[k8], hi, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // while the tensor cores work: the halves of the next chunk
    if (s + 1 < steps)
      split_chunk(next, &bars[(s + 1) % STAGES], ((s + 1) / STAGES) & 1,
                  aligned);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = chunk == 0 ? c[i] : acc[i] + c[i];

    if (chunk == chunks - 1) {
      // acc[4 j + i]: token row + 8 (i / 2), code 8 j + 2 t + i % 2: the
      // thread's codes in ascending order
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int gk = k0 + 8 * j + 2 * t + q;
          if (gk < k_end) {
            const float b = bias != nullptr ? bias[gk] : 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = acc[4 * j + 2 * h + q] + b;
              if (v > best[h] || best_k[h] == NO_CODE) {
                best[h] = v;
                best_k[h] = gk;
              }
            }
          }
        }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float s2 = __shfl_xor_sync(0xffffffffu, best[h], off);
      const int k2 = __shfl_xor_sync(0xffffffffu, best_k[h], off);
      take_better(best[h], best_k[h], s2, k2);
    }
    if (t == 0) {
      red_s[row + 8 * h] = best[h];
      red_k[row + 8 * h] = best_k[h];
    }
  }
  __syncthreads();
  const int gn = n0 + threadIdx.x;
  const bool mine = threadIdx.x < BN && gn < n_tok;
  if (splits == 1) {
    if (mine) out[gn] = red_k[threadIdx.x];
    return;
  }
  if (mine) {
    part_score[(size_t)split * n_tok + gn] = red_s[threadIdx.x];
    part_idx[(size_t)split * n_tok + gn] = red_k[threadIdx.x];
  }
  __threadfence();  // the block's partials before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&arrived[blockIdx.x], 1) == splits - 1;
    if (last) arrived[blockIdx.x] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // the other splits' partials after their arrivals
  if (mine) {
    float s = __ldcg(part_score + gn);
    int k = __ldcg(part_idx + gn);
    for (int p = 1; p < splits; ++p) {
      const float v = __ldcg(part_score + (size_t)p * n_tok + gn);
      if (v > s) {  // strict: an earlier split (lower codes) keeps its tie
        s = v;
        k = __ldcg(part_idx + (size_t)p * n_tok + gn);
      }
    }
    out[gn] = k;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// CUDA's cuTensorMapEncodeTiled, looked up once through the runtime (the
// library links no stub of libcuda).
EncodeTiled encode_tiled() {
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

// A (rows, depth) f32 matrix as a 2-D tensor, boxes of 128 rows x KB depths
// written with the 128-byte swizzle, zeros outside it.
bool matrix_map(CUtensorMap* map, const void* m, int rows, int depth) {
  const cuuint64_t dims[2] = {(cuuint64_t)depth, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)depth * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)KB, 128};
  const cuuint32_t steps[2] = {1, 1};
  return encode_tiled() != nullptr &&
         encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<void*>(m), dims, strides, box, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Once a device, before the first launch: allow the kernel its buffers of
// shared memory. Returns the CUDA error (0 on success).
extern "C" int favae_vq_nearest_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      vq_argmax, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
}

// x (n_tok, depth) f32, e (n_code, depth) f32, bias (n_code,) f32 or null;
// out (n_tok,) int32. The code tiles of 128 are cut into `splits` runs of
// tiles_per_split; splits > 1 needs part_score/part_idx (splits, n_tok)
// scratch and `arrived`, one int for each token tile of 128, zero before the
// first launch (the kernel leaves it zero). Returns the CUDA error of the
// launch (0 on success; cudaErrorNotSupported where CUDA gives no tensor
// map).
extern "C" int favae_vq_nearest(const void* x, const void* e, const void* bias,
                                void* part_score, void* part_idx,
                                void* arrived, void* out, int n_tok,
                                int n_code, int depth, int tiles_per_split,
                                int splits, void* stream) {
  const int aligned = depth % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                      (uintptr_t)e % 16 == 0;
  CUtensorMap xmap = {}, emap = {};
  if (aligned && !(matrix_map(&xmap, x, n_tok, depth) &&
                   matrix_map(&emap, e, n_code, depth)))
    return static_cast<int>(cudaErrorNotSupported);
  const dim3 grid((n_tok + BN - 1) / BN, splits);
  vq_argmax<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(e), xmap, emap,
      static_cast<const float*>(bias), static_cast<float*>(part_score),
      static_cast<int*>(part_idx), static_cast<int*>(arrived),
      static_cast<int*>(out), n_tok, n_code, depth, tiles_per_split, aligned);
  return static_cast<int>(cudaGetLastError());
}
