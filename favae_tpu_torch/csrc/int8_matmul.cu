// Weight-only int8 matmul: out = (x @ dequant(wq)) * scale.
//
// Replaces favae_tpu/ops/int8_matmul.py::matmul_int8 (body _matmul_kernel),
// whose grid walks N tiles with K whole. With M <= 16 rows the product is
// bound by the K * N bytes of int8 weights (9.4 MB at 1536 x 6144), and N/128
// column tiles alone (8 to 48) would leave most of the 132 SMs without work,
// so K is split as well: grid = (column tiles x chunks of K, row groups),
// each block writing its (8, 128) partial product, and a second small kernel
// adds the chunks in ascending order, applies the per-column scale after the
// sum and rounds once at the store. The weights never exist in bf16 in device
// memory. See int8_common.cuh for the item's inner loop.
#include "int8_common.cuh"

namespace {

using namespace favae;

__global__ void __launch_bounds__(THREADS)
matmul_partial(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
               float* part, int rows, int K, int N, int kc) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* red = smem + (size_t)kc * MR;
  phase_proj(x, K, rows, K, N, w, kc, part, xs, red, blockIdx.x, gridDim.x);
}

__global__ void matmul_finish(const float* __restrict__ part,
                              const float* __restrict__ scale, void* out,
                              int rows, int N, int nchunk, int out_f32) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * N) return;
  float a = 0.f;
  for (int ch = 0; ch < nchunk; ++ch) a += part[(size_t)ch * rows * N + i];
  a *= scale[i % N];
  if (out_f32)
    static_cast<float*>(out)[i] = a;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(a);
}

}  // namespace

// x (rows, K) bf16, wq (K, N) int8 row-major, scale (N,) f32, part
// (ceil(K / kc), rows, N) f32 scratch, out (rows, N) bf16 or f32. N % 4 == 0.
// Returns the CUDA error of the launches (0 on success).
extern "C" int favae_matmul_int8(const void* x, const void* wq,
                                 const void* scale, void* part, void* out,
                                 int rows, int K, int N, int kc, int out_f32,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunk = (K + kc - 1) / kc;
  const int items = (rows + MR - 1) / MR * nchunk * ((N + TN - 1) / TN);
  const size_t smem = ((size_t)kc * MR + RED_FLOATS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      matmul_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_partial<<<items, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<float*>(part), rows, K, N, kc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_finish<<<(rows * N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale), out,
      rows, N, nchunk, out_f32);
  return static_cast<int>(cudaGetLastError());
}
