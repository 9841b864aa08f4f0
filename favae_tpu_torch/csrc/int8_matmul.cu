// Weight-only int8 matmul: out = (x @ dequant(wq)) * scale, one launch.
//
// Replaces favae_tpu/ops/int8_matmul.py::matmul_int8 (body _matmul_kernel),
// whose grid walks N tiles with K whole. With M <= 16 rows the product is
// bound by the K * N bytes of int8 weights (9.4 MB at 1536 x 6144: 2.9 us at
// 3.35 TB/s; the 1.5 MB matrices' 0.5 us is under any launch), so what counts
// is bytes in flight on every SM and little else per byte:
//   * N / 128 column tiles alone (8 to 48) cannot fill 132 SMs, so K is split
//     as well, and the blocks that share a column tile form a thread-block
//     cluster along K (up to 8). Each block leaves its f32 partial in its own
//     shared memory; after cluster.sync() each rank takes a slice of the
//     tile's outputs, reads the peers' partials through distributed shared
//     memory in ascending rank, applies the per-column scale after the sum
//     and rounds once at the store. No partials in device memory, no second
//     launch, no float atomics: the same bits on every run. (Partials through
//     scratch with "the last block to arrive adds them" were measured beside
//     this on an H100 and took 1.2 to 2.4 us longer at every shape.)
//   * The block's product is int8_mma.cuh::tile_mma: a ring of TMA requests
//     for the weights, mma.sync m16n8k16 for the products, activations staged
//     once a block as bf16.
// Grid = (cluster, column tiles of 128, row groups of 8 NB); block = 128
// threads. The weights never exist in bf16 in device memory.
#include <cooperative_groups.h>

#include "int8_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace favae;

constexpr int TN = mma8::TN, THREADS = mma8::THREADS;

// dynamic shared memory: room to align the ring, the ring, the partial, the
// activations
__host__ __device__ inline size_t smem_bytes(int nb, int kc_pad) {
  return (size_t)mma8::RING_ALIGN + mma8::STAGES * mma8::STAGE_BYTES +
         (size_t)8 * nb * TN * sizeof(float) +
         (size_t)8 * nb * mma8::x_stride(kc_pad) * sizeof(__nv_bfloat16);
}

// The blocks of a column tile as one cluster: each rank takes a slice of the
// tile's outputs and reads the peers' partials in ascending rank.
template <int MRB>
__device__ __forceinline__ void cluster_finish(float* part,
                                               const float* __restrict__ scale,
                                               void* out, int rows, int N,
                                               int r0, int col0, int out_f32) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), ranks = cluster.num_blocks();
  const int per = MRB * TN / ranks;  // ranks is 1, 2, 4 or 8
  // the first scale this thread needs is on its way during the barrier
  const int c_first = col0 + (rank * per + threadIdx.x) % TN;
  const float s_first = c_first < N ? scale[c_first] : 0.f;
  cluster.sync();  // every rank's partial is in its shared memory
  for (int o = rank * per + threadIdx.x; o < (rank + 1) * per; o += THREADS) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = q < ranks ? cluster.map_shared_rank(part, q)[o] : 0.f;
    float a = v[0];
#pragma unroll
    for (int q = 1; q < 8; ++q)
      if (q < ranks) a += v[q];
    const int m = r0 + o / TN, c = col0 + o % TN;
    if (m < rows && c < N) {
      a *= c == c_first ? s_first : scale[c];
      if (out_f32)
        static_cast<float*>(out)[(size_t)m * N + c] = a;
      else
        static_cast<__nv_bfloat16*>(out)[(size_t)m * N + c] = __float2bfloat16(a);
    }
  }
  cluster.sync();  // no block leaves while a peer reads its partial
}

template <int NB>
__global__ void __launch_bounds__(THREADS)
matmul_int8_kernel(const __nv_bfloat16* __restrict__ x,
                   const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ scale, void* out, int rows, int K,
                   int N, int kc, int out_f32) {
  constexpr int MRB = 8 * NB;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[mma8::STAGES];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem) + mma8::RING_ALIGN - 1) /
      mma8::RING_ALIGN * mma8::RING_ALIGN);
  float* part = reinterpret_cast<float*>(ring + mma8::STAGES * mma8::STAGE_BYTES);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(part + MRB * TN);

  if (threadIdx.x == 0) mma8::init_barriers(bars);
  __syncthreads();
  const int rank = blockIdx.x;  // the rank in the cluster
  const int col0 = blockIdx.y * TN, r0 = blockIdx.z * MRB;
  const int k0 = min(K, rank * kc), k1 = min(K, k0 + kc);
  mma8::tile_mma<NB>(ring, bars, xs, part, x, K, r0, min(MRB, rows - r0), &wmap,
                     k0, k1, col0);
  cluster_finish<MRB>(part, scale, out, rows, N, r0, col0, out_f32);
}

template <int NB>
cudaError_t launch(const void* x, const CUtensorMap& wmap, const void* scale,
                   void* out, int rows, int K, int N, int kc, int ranks,
                   int out_f32, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, (N + TN - 1) / TN, (rows + 8 * NB - 1) / (8 * NB));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(NB, (kc + mma8::SK - 1) / mma8::SK * mma8::SK);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, matmul_int8_kernel<NB>,
                            static_cast<const __nv_bfloat16*>(x), wmap,
                            static_cast<const float*>(scale), out, rows, K, N,
                            kc, out_f32);
}

template <int NB>
cudaError_t allow_smem(int kc_max) {
  return cudaFuncSetAttribute(matmul_int8_kernel<NB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(NB, kc_max));
}

}  // namespace

// Dynamic shared memory of one block: nb row groups of 8 (1 or 2), chunk kc
// of K.
extern "C" int favae_matmul_int8_smem(int nb, int kc) {
  return (int)smem_bytes(nb, (kc + mma8::SK - 1) / mma8::SK * mma8::SK);
}

// Once a device, before the first launch: allow both variants the shared
// memory of their largest chunk. Returns the CUDA error (0 on success).
extern "C" int favae_matmul_int8_init(int kc_max) {
  cudaError_t err = allow_smem<1>(kc_max);
  if (err == cudaSuccess) err = allow_smem<2>(kc_max);
  return static_cast<int>(err);
}

// x (rows, K) bf16, wq (K, N) int8 row-major, scale (N,) f32, out (rows, N)
// bf16 or f32. N % 16 == 0, wq 16-byte aligned; nb 1 or 2, ranks (the
// cluster along K) 1, 2, 4 or 8 with ranks * kc >= K. Returns the CUDA error
// of the launch (0 on success; cudaErrorNotSupported where CUDA gives
// no tensor map).
extern "C" int favae_matmul_int8(const void* x, const void* wq,
                                 const void* scale, void* out, int rows, int K,
                                 int N, int nb, int ranks, int kc, int out_f32,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  if (!mma8::weight_map(&wmap, wq, 2, dims))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = cudaErrorInvalidValue;
  if (nb == 1)
    err = launch<1>(x, wmap, scale, out, rows, K, N, kc, ranks, out_f32, s);
  else if (nb == 2)
    err = launch<2>(x, wmap, scale, out, rows, K, N, kc, ranks, out_f32, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
