// Pieces shared by the int8 serving kernels (ffn_int8.cu, decode_step.cu,
// int8_matmul.cu over int8_mma.cuh): the exact int8 -> f32 conversion, block
// and warp reductions, sums over chunks of partial products with their loads
// in flight, and the tanh GELU.
//
// The TPU kernels walk a sequential grid and carry their sums in scratch
// memory. Blocks on the card run in no order, so the work is cut into items
// (rows, one 128-column tile, one chunk of K) that any block can take; each
// item's f32 partial goes to a scratch buffer indexed by chunk, and whoever
// consumes the product adds the chunks in ascending order and applies the
// per-column scale after the sum. No float atomics anywhere: the same inputs
// give the same bits from run to run. Products of bf16-rounded values and
// int8 are exact in f32, so only the order of the f32 sum differs from the
// plain PyTorch versions. Measured on an H100, these kernels are bound by
// load latency, not by bandwidth: a warp runs its instructions in order, so
// every load of weights or scratch is started in a batch ahead of its first
// use.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace favae {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MR = 8;                        // activation rows per item
constexpr int TN = 128;                      // columns per item

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

// Scratch written earlier in the same launch by another block is read past
// the L1 cache.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Four int8 packed in a word -> four floats, exactly.
__device__ __forceinline__ void dequant4(uint32_t w, float (&f)[4]) {
  w ^= 0x80808080u;  // two's complement -> offset by 128
  f[0] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7653)) - 8388736.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sum (or max) over the block in a fixed order; sh holds WARPS floats. Every
// thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  v = warp_sum(v);
  __syncthreads();  // sh may still be read from the previous call
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += sh[w];
  return s;
}

__device__ __forceinline__ float block_max(float v, float* sh) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = sh[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) s = fmaxf(s, sh[w]);
  return s;
}

// A warp runs its instructions in order, so a load whose value is used at
// once stalls the loads behind it. These helpers start up to N loads first (a
// count below N repeats the last address) and add or store afterwards.
template <int N, typename T>
__device__ __forceinline__ void load_many(float (&v)[N], const T* p,
                                          size_t stride, int n) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = load_cg(p + (size_t)min(i, n - 1) * stride);
}

// sum over i < n of p[i * stride], added in ascending order, N loads in
// flight.
template <int N = 8>
__device__ __forceinline__ float sum_strided(const float* p, size_t stride,
                                             int n) {
  float a = 0.f;
  for (int i0 = 0; i0 < n; i0 += N) {
    float v[N];
    load_many(v, p + (size_t)i0 * stride, stride, n - i0);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i0 + i < n) a += v[i];
  }
  return a;
}

// tanh form of GELU, as the TPU kernels use (jax.nn.gelu approximate=True).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// buf[c] = sum over chunks of part[ch * chunk_stride + c], c in [0, d), the
// chunks added in ascending order. A thread owns up to 8 columns at a time
// and takes 8 chunks of them at once, 64 loads in flight (each dependent
// trip to L2 costs ~0.65 us inside the whole-step kernel on an H100).
__device__ __forceinline__ void sum_chunks_row(float* buf, const float* part,
                                               int nchunk, size_t chunk_stride,
                                               int d) {
  for (int c0 = threadIdx.x; c0 < d; c0 += THREADS * 8) {
    const int n = (d - c0 + THREADS - 1) / THREADS;  // this thread's columns
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = 0.f;
    for (int ch = 0; ch < nchunk; ch += 8) {
      float v[8][8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        load_many(v[c], part + (size_t)min(ch + c, nchunk - 1) * chunk_stride +
                            c0, THREADS, n);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (ch + c < nchunk) {
#pragma unroll
          for (int j = 0; j < 8; ++j) a[j] += v[c][j];
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) buf[c0 + j * THREADS] = a[j];
  }
  __syncthreads();
}

}  // namespace favae
