// Fused int8 feed-forward block of CAT decode:
//   y = x + fc2(LN_mid(gelu_tanh(fc1(LN_in(x)))))
// with int8 W1 and gamma-folded int8 W2', the mid LayerNorm folded into
//   inv * (h @ W2' - mu * c),  c = colsum(dequantised W2').
//
// Replaces favae_tpu/ops/ffn_int8.py::ffn_block_int8 (body _ffn_kernel). The
// TPU kernel carries acc, sum(h) and sum(h^2) across a sequential grid over F
// tiles. Blocks on the card run in no order, so the block is a fixed sequence
// of four launches over scratch buffers the wrapper allocates:
//   1. ffn_ln_in: one block a row, xn = bf16(LN_in(x) * gamma) kept as f32;
//   2. ffn_fc1: items (128 columns of F, chunk of K) -> partial products;
//   3. ffn_fc2: items (128 columns of K, chunk of F): h = gelu(sum of the fc1
//      chunks * s1) is rebuilt for the item's slice of F while it is loaded,
//      its f32 sums are taken before the bf16 rounding, then the partial
//      product with W2';
//   4. ffn_finish: one block a row adds the chunks in ascending order and
//      stores bf16(x + inv * (acc * s2 - mu * c)).
// No float atomics. Bound: the 2 * K * 4K bytes of int8 weights (18.9 MB at
// K 1536); the scratch (about 2 MB) stays in L2.
#include "int8_common.cuh"

namespace {

using namespace favae;

__global__ void __launch_bounds__(THREADS)
ffn_ln_in(const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
          float* xn, int d, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* buf = smem;
  float* sh = smem + d;
  const int row = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += THREADS)
    buf[c] = __bfloat162float(x[(size_t)row * d + c]);
  __syncthreads();
  row_norm_out(buf, d, g, eps, sh, xn + (size_t)row * d);
}

__global__ void __launch_bounds__(THREADS)
ffn_fc1(const float* xn, const int8_t* __restrict__ w1, float* part1, int rows,
        int d, int F, int kc) {
  extern __shared__ __align__(16) float smem[];
  phase_proj(xn, d, rows, d, F, w1, kc, part1, smem, smem + (size_t)kc * MR,
             blockIdx.x, gridDim.x);
}

__global__ void __launch_bounds__(THREADS)
ffn_fc2(const float* part1, int nk1, const float* __restrict__ s1,
        const int8_t* __restrict__ w2, float* part2, float* stat, int rows,
        int d, int F, int kc) {
  extern __shared__ __align__(16) float smem[];
  phase_fc2(part1, nk1, s1, rows, F, d, w2, kc, part2, stat, smem,
            smem + (size_t)kc * MR, blockIdx.x, gridDim.x);
}

__global__ void __launch_bounds__(THREADS)
ffn_finish(const __nv_bfloat16* __restrict__ x, const float* part2,
           const float* stat, int nchunk, const float* __restrict__ s2,
           const float* __restrict__ c2, __nv_bfloat16* y, int rows, int d,
           int F, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x;
  ffn_row_finish(smem, x, part2, stat, nchunk, rows, row, d, F, s2, c2, eps);
  for (int c = threadIdx.x; c < d; c += THREADS)
    y[(size_t)row * d + c] = __float2bfloat16(smem[c]);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// Floats of scratch the launches below need.
extern "C" long long favae_ffn_int8_scratch(int rows, int d, int F, int kc1,
                                            int kc2) {
  const long long nk1 = (d + kc1 - 1) / kc1, nk2 = (F + kc2 - 1) / kc2;
  return (long long)rows * d + nk1 * rows * F + nk2 * rows * d + nk2 * rows * 2;
}

// x, y (rows, d) bf16; gamma_in (d,) f32; w1q (d, F) int8, s1 (F,) f32; w2q
// (F, d) int8, s2, c2 (d,) f32; scratch as sized above. d % 4 == 0.
// Returns the CUDA error of the launches (0 on success).
extern "C" int favae_ffn_int8(const void* x, const void* gamma_in,
                              const void* w1q, const void* s1, const void* w2q,
                              const void* s2, const void* c2, void* scratch,
                              void* y, int rows, int d, int F, int kc1, int kc2,
                              float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nk1 = (d + kc1 - 1) / kc1, nk2 = (F + kc2 - 1) / kc2;
  const int ngroup = (rows + MR - 1) / MR;
  float* xn = static_cast<float*>(scratch);
  float* part1 = xn + (size_t)rows * d;
  float* part2 = part1 + (size_t)nk1 * rows * F;
  float* stat = part2 + (size_t)nk2 * rows * d;
  const size_t row_smem = ((size_t)d + WARPS) * sizeof(float);
  const size_t smem1 = ((size_t)kc1 * MR + RED_FLOATS) * sizeof(float);
  const size_t smem2 = ((size_t)kc2 * MR + RED_FLOATS) * sizeof(float);
  cudaError_t err = allow_smem(ffn_ln_in, row_smem);
  if (err == cudaSuccess) err = allow_smem(ffn_fc1, smem1);
  if (err == cudaSuccess) err = allow_smem(ffn_fc2, smem2);
  if (err == cudaSuccess) err = allow_smem(ffn_finish, row_smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  ffn_ln_in<<<rows, THREADS, row_smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(gamma_in), xn, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_fc1<<<ngroup * nk1 * ((F + TN - 1) / TN), THREADS, smem1, s>>>(
      xn, static_cast<const int8_t*>(w1q), part1, rows, d, F, kc1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_fc2<<<ngroup * nk2 * ((d + TN - 1) / TN), THREADS, smem2, s>>>(
      part1, nk1, static_cast<const float*>(s1),
      static_cast<const int8_t*>(w2q), part2, stat, rows, d, F, kc2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_finish<<<rows, THREADS, row_smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), part2, stat, nk2,
      static_cast<const float*>(s2), static_cast<const float*>(c2),
      static_cast<__nv_bfloat16*>(y), rows, d, F, eps);
  return static_cast<int>(cudaGetLastError());
}
