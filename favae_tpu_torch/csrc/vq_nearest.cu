// Nearest codebook entry per token: idx[n] = argmax_k (x[n] . e[k] + bias[k]).
//
// Replaces favae_tpu/ops/vq_pallas.py::vq_nearest_pallas (body
// _vq_argmax_kernel). The TPU kernel walks the codebook along a sequential
// grid axis and carries the running best in VMEM scratch; blocks on the card
// run in parallel and in no order, so nothing is carried between them here.
//
// Design:
//   * Block = BN tokens x one split of the codebook. Inside the block a loop
//     walks the split's code tiles of BK codes in ascending order; each tile
//     is scored in f32 FMA from BD-deep chunks of x and e staged in shared
//     memory, and a running (best score, best index) per token stays in
//     registers. Codes k >= K are masked, not padded.
//   * Warp w owns tokens 8w..8w+7 of the block, lane l owns codes 4l..4l+3 of
//     the tile: 32 accumulators a thread, x read as a shared-memory broadcast.
//   * The codebook is split across gridDim.y so that N/BN token tiles still
//     fill the SMs (N = 4096 gives only 64 token tiles). Each split writes its
//     (score, index) pair; a second tiny kernel merges the splits in
//     ascending order.
//   * Ties go to the lowest index: lowest code within a thread, lowest index
//     across the lanes of a warp, and a strict '>' when a later tile or a
//     later split improves the best.
//
// Bound (celebahq_expe5, batch 16: N = 4096, K = 1024, D = 256): 2*N*K*D =
// 2.1 GFLOP of f32 FMA, about 32 us at the H100's 67 TFLOP/s f32 rate outside
// the tensor cores; the 5 MB of inputs take about 1.5 us at 3.35 TB/s, so
// the kernel is bound by operations.
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;         // tokens per block
constexpr int BK = 128;        // codes per tile
constexpr int BD = 32;         // depth of one staged chunk
constexpr int THREADS = 256;   // 8 warps
constexpr int TN = 8;          // tokens per warp
constexpr int TK = 4;          // codes per lane
constexpr int XS_LD = BN + 4;  // padded rows: fewer bank conflicts, 16 B aligned
constexpr int ES_LD = BK + 4;

static_assert(THREADS / 32 * TN == BN, "warps must cover the token tile");
static_assert(32 * TK == BK, "lanes must cover the code tile");

__device__ __forceinline__ void take_better(float& s, int& k, float s2, int k2) {
  if (s2 > s || (s2 == s && k2 < k)) {
    s = s2;
    k = k2;
  }
}

__global__ void __launch_bounds__(THREADS)
vq_argmax_split(const float* __restrict__ x, const float* __restrict__ e,
                const float* __restrict__ bias, float* __restrict__ part_score,
                int* __restrict__ part_idx, int n_tok, int n_code, int depth,
                int tiles_per_split) {
  __shared__ __align__(16) float xs[BD][XS_LD];
  __shared__ __align__(16) float es[BD][ES_LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int k_begin = split * tiles_per_split * BK;
  const int k_end = min(n_code, k_begin + tiles_per_split * BK);

  float best[TN];
  int best_k[TN];
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    best[i] = __int_as_float(0xff800000);  // -inf
    best_k[i] = k_begin;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    float acc[TN][TK];
#pragma unroll
    for (int i = 0; i < TN; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < depth; d0 += BD) {
      // consecutive threads read consecutive floats of one row: coalesced
      for (int i = tid; i < BN * BD; i += THREADS) {
        const int n = i / BD, d = i % BD;
        const int gn = n0 + n, gd = d0 + d;
        xs[d][n] = (gn < n_tok && gd < depth) ? x[(size_t)gn * depth + gd] : 0.f;
      }
      for (int i = tid; i < BK * BD; i += THREADS) {
        const int k = i / BD, d = i % BD;
        const int gk = k0 + k, gd = d0 + d;
        es[d][k] = (gk < k_end && gd < depth) ? e[(size_t)gk * depth + gd] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < BD; ++d) {
        const float4 xa = *reinterpret_cast<const float4*>(&xs[d][warp * TN]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[d][warp * TN + 4]);
        const float4 ev = *reinterpret_cast<const float4*>(&es[d][lane * TK]);
        const float xv[TN] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float evv[TK] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
        for (int i = 0; i < TN; ++i)
#pragma unroll
          for (int j = 0; j < TK; ++j) acc[i][j] = fmaf(xv[i], evv[j], acc[i][j]);
      }
      __syncthreads();
    }

    float bv[TK];
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      const int gk = k0 + lane * TK + j;
      bv[j] = (bias != nullptr && gk < k_end) ? bias[gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      float s = __int_as_float(0xff800000);
      int k = 0x7fffffff;  // a lane without a valid code loses every tie
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int gk = k0 + lane * TK + j;
        const float v = acc[i][j] + bv[j];
        if (gk < k_end && (v > s || k == 0x7fffffff)) {
          s = v;
          k = gk;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
        const int k2 = __shfl_xor_sync(0xffffffffu, k, off);
        take_better(s, k, s2, k2);
      }
      if (s > best[i]) {  // strict: an earlier tile keeps its tie
        best[i] = s;
        best_k[i] = k;
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const int gn = n0 + warp * TN + i;
      if (gn < n_tok) {
        part_score[(size_t)split * n_tok + gn] = best[i];
        part_idx[(size_t)split * n_tok + gn] = best_k[i];
      }
    }
  }
}

__global__ void vq_argmax_merge(const float* __restrict__ part_score,
                                const int* __restrict__ part_idx,
                                int* __restrict__ out, int n_tok, int splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_tok) return;
  float s = part_score[n];
  int k = part_idx[n];
  for (int p = 1; p < splits; ++p) {
    const float v = part_score[(size_t)p * n_tok + n];
    if (v > s) {  // strict: an earlier split (lower codes) keeps its tie
      s = v;
      k = part_idx[(size_t)p * n_tok + n];
    }
  }
  out[n] = k;
}

}  // namespace

// x (n_tok, depth) f32, e (n_code, depth) f32, bias (n_code,) f32 or null;
// part_score/part_idx (splits, n_tok) scratch; out (n_tok,) int32.
// Returns the CUDA error of the launches (0 on success).
extern "C" int favae_vq_nearest(const void* x, const void* e, const void* bias,
                                void* part_score, void* part_idx, void* out,
                                int n_tok, int n_code, int depth,
                                int tiles_per_split, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_tok + BN - 1) / BN, splits);
  vq_argmax_split<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(e),
      static_cast<const float*>(bias), static_cast<float*>(part_score),
      static_cast<int*>(part_idx), n_tok, n_code, depth, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vq_argmax_merge<<<(n_tok + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_score), static_cast<const int*>(part_idx),
      static_cast<int*>(out), n_tok, splits);
  return static_cast<int>(cudaGetLastError());
}
