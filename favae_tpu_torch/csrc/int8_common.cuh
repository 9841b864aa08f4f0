// What the three int8 kernels (int8_matmul.cu, ffn_int8.cu, decode_step.cu)
// share: a few bf16 rows of activations times a streamed int8 (K, N) weight
// tile with f32 accumulation, and the small row-wise passes around it.
//
// The TPU kernels walk a sequential grid and carry their sums in scratch
// memory. Blocks on the card run in no order, so the work is cut into items
// (8 rows, one 128-column tile, one chunk of K) that any block can take:
//   * the item's 8 x chunk activations sit in shared memory as f32 holding
//     bf16-rounded values, transposed ([k][row]) so one k is two 16-byte
//     broadcast reads;
//   * the block's 8 warps take every 8th k-row of the chunk; a lane owns 4
//     neighbouring columns, so a warp reads 128 contiguous bytes of a weight
//     row with one 4-byte load a lane, 8 rows in flight;
//   * int8 -> f32 goes through the exponent trick (byte into the mantissa of
//     2^23, subtract), which is exact; products of bf16-rounded values and
//     int8 are exact in f32, so only the order of the f32 sum differs from
//     the plain PyTorch versions;
//   * the warps' sums meet in shared memory in a fixed order and the item's
//     (8, 128) partial goes to a scratch buffer indexed by chunk. Whoever
//     consumes the product adds the chunks in ascending order and applies the
//     per-column scale after the sum. No float atomics anywhere: the same
//     inputs give the same bits from run to run.
// Measured on an H100, these products are bound by load latency, not by
// bandwidth: a warp runs its instructions in order, so every load of weights
// or scratch is started in a batch ahead of its first use.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace favae {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MR = 8;                        // activation rows per item
constexpr int TN = 128;                      // columns per item: 32 lanes x 4
constexpr int RED_FLOATS = WARPS * MR * TN;  // cross-warp reduction buffer
constexpr int UNROLL = 8;                    // weight rows in flight per warp

static_assert(WARPS == MR, "the fills give each warp one activation row");

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

__device__ __forceinline__ void mac_row(const float* xk, const float (&f)[4],
                                        float (&acc)[MR][4]) {
  const float4 xa = *reinterpret_cast<const float4*>(xk);
  const float4 xb = *reinterpret_cast<const float4*>(xk + 4);
  const float xv[MR] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv[m], f[j], acc[m][j]);
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

// sum over i < n of p[i * stride], added in ascending order.
__device__ __forceinline__ float sum_strided(const float* p, size_t stride,
                                             int n) {
  float a = 0.f;
  for (int i0 = 0; i0 < n; i0 += 8) {
    float v[8];
    load_many(v, p + (size_t)i0 * stride, stride, n - i0);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i0 + i < n) a += v[i];
  }
  return a;
}

// tanh form of GELU, as the TPU kernels use (jax.nn.gelu approximate=True).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// Shared-memory fill of one item: xs[(k - k0) * MR + m] = src[r0 + m][k] for
// k in [k0, k1), rows past `rows_valid` zero. Warp m fills row m.
template <typename T>
__device__ __forceinline__ void fill_rows(float* xs, const T* src, int ld,
                                          int r0, int rows_valid, int k0,
                                          int k1) {
  const int m = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = (k1 - k0 - lane + 31) / 32;  // this lane's elements
  if (m < rows_valid) {
    const T* row = src + (size_t)(r0 + m) * ld + k0 + lane;
    for (int i0 = 0; i0 < n; i0 += 8) {
      float v[8];
      load_many(v, row + 32 * i0, 32, n - i0);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i0 + i < n) xs[(lane + 32 * (i0 + i)) * MR + m] = v[i];
    }
  } else {
    for (int i = 0; i < n; ++i) xs[(lane + 32 * i) * MR + m] = 0.f;
  }
  __syncthreads();
}

// The item's product: xs (chunk x MR, filled) times w[k0:k1, col0:col0+TN]
// (int8, row stride ldw, n columns in all), summed over the block's warps in
// a fixed order and written to out[m * ldo + col0 + c] for m < rows_valid.
// red holds RED_FLOATS floats. Ends with the block synchronised, so xs and
// red may be reused at once.
__device__ __forceinline__ void tile_mac_reduce(
    const float* xs, float* red, const int8_t* __restrict__ w, int ldw, int n,
    int k0, int k1, int col0, float* out, int ldo, int rows_valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = col0 + lane * 4;
  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  if (col < n) {
    const int8_t* wc = w + col;
    int k = k0 + warp;
    for (; k + WARPS * (UNROLL - 1) < k1; k += WARPS * UNROLL) {
      uint32_t wv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        wv[u] = __ldg(reinterpret_cast<const uint32_t*>(
            wc + (size_t)(k + WARPS * u) * ldw));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float f[4];
        dequant4(wv[u], f);
        mac_row(xs + (k + WARPS * u - k0) * MR, f, acc);
      }
    }
    for (; k < k1; k += WARPS) {
      float f[4];
      dequant4(__ldg(reinterpret_cast<const uint32_t*>(wc + (size_t)k * ldw)), f);
      mac_row(xs + (k - k0) * MR, f, acc);
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m)
    *reinterpret_cast<float4*>(&red[(warp * MR + m) * TN + lane * 4]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int o = threadIdx.x; o < MR * TN; o += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) s += red[ww * MR * TN + o];
    const int m = o / TN, c = col0 + o % TN;
    if (m < rows_valid && c < n) out[(size_t)m * ldo + c] = s;
  }
  __syncthreads();
}

// All items of out = x @ W for one (K, N) int8 matrix, dealt over the
// blocks: x (rows, K) with row stride ldx, kc the chunk of K, part
// (chunks, rows, N) f32. `block` of `nblocks` takes every nblocks-th item.
template <typename T>
__device__ __forceinline__ void phase_proj(
    const T* x, int ldx, int rows, int K, int N, const int8_t* __restrict__ w,
    int kc, float* part, float* xs, float* red, int block, int nblocks) {
  const int ntile = (N + TN - 1) / TN;
  const int nchunk = (K + kc - 1) / kc;
  const int ngroup = (rows + MR - 1) / MR;
  const int items = ngroup * nchunk * ntile;
  for (int it = block; it < items; it += nblocks) {
    const int t = it % ntile;
    const int c = (it / ntile) % nchunk;
    const int r0 = it / (ntile * nchunk) * MR;
    const int k0 = c * kc, k1 = min(K, k0 + kc);
    const int rv = min(MR, rows - r0);
    fill_rows(xs, x, ldx, r0, rv, k0, k1);
    tile_mac_reduce(xs, red, w, N, N, k0, k1, t * TN,
                    part + ((size_t)c * rows + r0) * N, N, rv);
  }
}

// buf[c] = sum over chunks of part[ch * chunk_stride + c], c in [0, d), the
// chunks added in ascending order. A thread owns up to 8 columns at a time
// and takes the chunks two by two, 16 loads in flight.
__device__ __forceinline__ void sum_chunks_row(float* buf, const float* part,
                                               int nchunk, size_t chunk_stride,
                                               int d) {
  for (int c0 = threadIdx.x; c0 < d; c0 += THREADS * 8) {
    const int n = (d - c0 + THREADS - 1) / THREADS;  // this thread's columns
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = 0.f;
    for (int ch = 0; ch < nchunk; ch += 2) {
      float v[2][8];
      load_many(v[0], part + (size_t)ch * chunk_stride + c0, THREADS, n);
      load_many(v[1], part + (size_t)min(ch + 1, nchunk - 1) * chunk_stride + c0,
                THREADS, n);
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] += v[0][j];
      if (ch + 1 < nchunk) {
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] += v[1][j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) buf[c0 + j * THREADS] = a[j];
  }
  __syncthreads();
}

// Two-pass LayerNorm statistics of buf[0:d] (shared memory): returns the
// mean and sets rstd = 1 / sqrt(var + eps).
__device__ __forceinline__ float row_stats(const float* buf, int d, float eps,
                                           float* sh, float& rstd) {
  float s = 0.f;
  for (int c = threadIdx.x; c < d; c += THREADS) s += buf[c];
  const float mean = block_sum(s, sh) / d;
  float v = 0.f;
  for (int c = threadIdx.x; c < d; c += THREADS) {
    const float diff = buf[c] - mean;
    v += diff * diff;
  }
  rstd = 1.f / sqrtf(block_sum(v, sh) / d + eps);
  return mean;
}

// xn[c] = bf16_round((buf[c] - mean) * rstd * g[c]), the input of the next
// projection, kept as f32.
__device__ __forceinline__ void row_norm_out(const float* buf, int d,
                                             const float* __restrict__ g,
                                             float eps, float* sh, float* xn) {
  float rstd;
  const float mean = row_stats(buf, d, eps, sh, rstd);
  for (int c = threadIdx.x; c < d; c += THREADS)
    xn[c] = bf16_round((buf[c] - mean) * rstd * g[c]);
}

// The fc2 half of the folded FFN, all items dealt over the blocks: the
// item's slice of h = gelu(sum_chunks(part1) * s1) is rebuilt while it is
// loaded (f32 sums of h and h^2 taken before the bf16 rounding, written once
// per chunk of F by the items of column tile 0), then multiplied by the
// gamma-folded int8 W2. part1 (nk1, rows, F), part2 (chunks of F, rows, d),
// stat (chunks of F, rows, 2).
__device__ __forceinline__ void phase_fc2(
    const float* part1, int nk1, const float* __restrict__ s1, int rows, int F,
    int d, const int8_t* __restrict__ w2, int kc, float* part2, float* stat,
    float* xs, float* red, int block, int nblocks) {
  const int ntile = (d + TN - 1) / TN;
  const int nchunk = (F + kc - 1) / kc;
  const int ngroup = (rows + MR - 1) / MR;
  const int items = ngroup * nchunk * ntile;
  const int m = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int it = block; it < items; it += nblocks) {
    const int t = it % ntile;
    const int c = (it / ntile) % nchunk;
    const int r0 = it / (ntile * nchunk) * MR;
    const int k0 = c * kc, k1 = min(F, k0 + kc);
    const int rv = min(MR, rows - r0);
    float a1 = 0.f, a2 = 0.f;
    // four elements of h a lane at a time, their chunk loads in flight
    // together; each element's chunks are still added in ascending order
    for (int kk0 = lane; kk0 < k1 - k0; kk0 += 32 * 4) {
      const int n = min(4, (k1 - k0 - kk0 + 31) / 32);
      float h[4] = {0.f, 0.f, 0.f, 0.f};
      if (m < rv) {
        const float* src = part1 + (size_t)(r0 + m) * F + k0 + kk0;
        const size_t chunk = (size_t)rows * F;
        for (int ch = 0; ch < nk1; ch += 2) {
          float v[2][4];
          load_many(v[0], src + ch * chunk, 32, n);
          load_many(v[1], src + min(ch + 1, nk1 - 1) * chunk, 32, n);
#pragma unroll
          for (int e = 0; e < 4; ++e) h[e] += v[0][e];
          if (ch + 1 < nk1) {
#pragma unroll
            for (int e = 0; e < 4; ++e) h[e] += v[1][e];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e >= n) break;
        const int kk = kk0 + 32 * e;
        float hv = 0.f;
        if (m < rv) {
          hv = gelu_tanh(h[e] * s1[k0 + kk]);
          a1 += hv;
          a2 += hv * hv;
        }
        xs[kk * MR + m] = bf16_round(hv);
      }
    }
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (t == 0 && lane == 0 && m < rv) {
      float* st = stat + ((size_t)c * rows + r0 + m) * 2;
      st[0] = a1;
      st[1] = a2;
    }
    __syncthreads();
    tile_mac_reduce(xs, red, w2, d, d, k0, k1, t * TN,
                    part2 + ((size_t)c * rows + r0) * d, d, rv);
  }
}

// The end of the folded FFN for one row, by one block:
// buf[c] = base[c] + inv * (sum_chunks(part2)[c] * s2[c] - mu * c2[c]) with
// (mu, inv) from the chunk sums of h. `base` is the row the block adds to.
// Leaves buf filled and the block synchronised.
__device__ __forceinline__ void ffn_row_finish(
    float* buf, const float* base_f32, const __nv_bfloat16* base_bf16,
    const float* part2, const float* stat, int nchunk, int rows, int row,
    int d, int F, const float* __restrict__ s2, const float* __restrict__ c2,
    float eps) {
  const float m1 = sum_strided(stat + (size_t)row * 2, (size_t)rows * 2, nchunk);
  const float m2 = sum_strided(stat + (size_t)row * 2 + 1, (size_t)rows * 2,
                               nchunk);
  const float mu = m1 / F;
  const float var = fmaxf(m2 / F - mu * mu, 0.f);
  const float inv = 1.f / sqrtf(var + eps);
  sum_chunks_row(buf, part2 + (size_t)row * d, nchunk, (size_t)rows * d, d);
  for (int c = threadIdx.x; c < d; c += THREADS) {
    const float base = base_f32 != nullptr
                           ? __ldcg(base_f32 + (size_t)row * d + c)
                           : __bfloat162float(base_bf16[(size_t)row * d + c]);
    buf[c] = base + inv * (buf[c] * s2[c] - mu * c2[c]);
  }
  __syncthreads();
}

}  // namespace favae
