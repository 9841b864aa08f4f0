// A few rows times a bf16 weight: y = x w^T, x (rows <= 16, K), w (N, K) as
// nn.Linear keeps it, y (rows, N), all bf16; f32 sums, one rounding of y.
//
// Replaces no TPU kernel: the JAX package leaves the token step's
// projections to XLA (favae_tpu/models/gpt.py under jit). On the card they
// were cuBLAS's 8-row products, ~0.97 of the ~1.80 ms token of gpt2_medium
// (seven products a layer, 25.26M weights: 1.21 GB a token). At 16 rows or
// fewer a product does at most 16 operations a weight byte, against the
// card's ~295, so it is bound by its weight's bytes: 3.1 MB (to_q, to_out,
// 0.94 us at 3.35 TB/s) to 18.9 MB (fc1, fc2, 5.6 us). What counts is every
// SM streaming from the start, and nothing else on the way:
//   * Occupancy. The N rows of the weight are cut into tiles of TN = 64, too
//     few (16 to 96) to fill 132 SMs, so K is split as well: the blocks of a
//     tile form a thread-block cluster along K (up to 8 ranks). Each rank
//     owns a slice of the tile's outputs: every block pushes its f32
//     partial of each peer's slice into that peer's shared memory (st.async
//     through distributed shared memory, counted in bytes on the peer's
//     mbarrier), and the owner adds the slices in ascending rank and rounds
//     once at the store: one launch, no workspace in device memory, no
//     float atomics, the same bits in every replay. (Pulling the partials
//     after a cluster barrier, as int8_matmul.cu does, puts a barrier
//     across the cluster and a round trip more on the product's tail:
//     gpt2_medium's token step took 1.70 ms against 1.53 on an H100.)
//   * Streaming. A block's weight rows come through a ring of `depth` (up
//     to MAX_DEPTH) buffers of 64 rows x 64 depths (8 KB), each one TMA
//     request through a tensor map of w with the 128-byte swizzle,
//     reporting to its mbarrier; one thread asks, and every stage of the
//     ring is in flight before the first product. The plan takes the
//     deepest ring that leaves every block of the launch resident at once.
//     Rows past N and depths past K arrive as zeros.
//   * Products: mma.sync m16n8k16 (bf16 x bf16 -> f32) with the weight tile
//     as the 16-row operand (ldmatrix.x4 from the swizzled buffer, no bank
//     conflicts) and the activations' 8-row groups as the n = 8 side, so 8
//     rows need no padding; a second group (NB = 2) reuses each weight
//     fragment. The activations of the block's chunk of K are staged once
//     (cp.async, int8_mma.cuh::fill_x) at a row stride of 4 words mod 32.
//   * Programmatic dependent launch. The weights depend on no earlier
//     kernel, so a block asks for its first stages before
//     griddepcontrol.wait and reads x only after it: launched with
//     cudaLaunchAttributeProgrammaticStreamSerialization, the weights stream
//     while the kernel before drains and through the launch gap. After the
//     wait the block lets its own dependents launch.
// Sums: each warp owns 16 output rows and adds its k-steps in ascending
// order (even and odd steps in two accumulators, added at the end), the
// ranks in ascending order: deterministic; only the order of the f32 sum
// differs from the plain PyTorch version.
// Grid = (cluster ranks, N / TN tiles); block = 128 threads.
#include "int8_mma.cuh"

namespace {

namespace mma8 = favae::mma8;

constexpr int TN = 64;               // weight rows (outputs) of a tile
constexpr int WARPS = TN / 16;       // a warp owns 16 of them
constexpr int THREADS = 32 * WARPS;
constexpr int SK = 64;               // depths of a stage: 128 bytes a row
constexpr int STEPS = SK / 16;       // k-steps of a stage
constexpr int MAX_DEPTH = 6;         // stages of the ring, at most
constexpr int STAGE_BYTES = TN * SK * 2;
constexpr int RING_ALIGN = 1024;     // the 128-byte swizzle repeats every 8 rows
constexpr int PART_LD = TN + 4;      // partial row stride: conflict-free writes

// dynamic shared memory: room to align the ring, the ring, the peers'
// partials of this block's slice, the activations
__host__ __device__ inline size_t smem_bytes(int nb, int kc_pad, int depth) {
  return (size_t)RING_ALIGN + (size_t)depth * STAGE_BYTES +
         (size_t)8 * nb * TN * sizeof(float) +
         (size_t)8 * nb * mma8::x_stride(kc_pad) * sizeof(__nv_bfloat16);
}

// The ring's `depth` barriers and the partials' one, bars[MAX_DEPTH].
__device__ __forceinline__ void init_barriers(uint64_t* bars, int depth) {
  for (int i = 0; i <= MAX_DEPTH; ++i)
    if (i < depth || i == MAX_DEPTH)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       mma8::shared_address(&bars[i]))
                   : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Stage s of the block's weights, by the calling thread alone: depths
// k0 + s SK .. + SK - 1 of rows col0 .. col0 + TN - 1.
__device__ __forceinline__ void load_stage(uint8_t* ring, uint64_t* bars,
                                           int s, int depth,
                                           const CUtensorMap* wmap, int k0,
                                           int col0) {
  const uint32_t bar = mma8::shared_address(&bars[s % depth]);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(STAGE_BYTES)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(
          mma8::shared_address(ring + (s % depth) * STAGE_BYTES)),
      "l"(reinterpret_cast<uint64_t>(wmap)), "r"(bar), "r"(k0 + s * SK),
      "r"(col0)
      : "memory");
}

// A shared::cta address of this block as the same address in block `rank`
// of the cluster.
__device__ __forceinline__ uint32_t peer_address(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes into a peer's shared memory, counted on its barrier `bar`.
__device__ __forceinline__ void push16(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// The products of one landed stage (TN rows x SK depths at `buf`, as TMA
// wrote it: the 16-byte piece p of row r at piece p ^ (r % 8)) with
// xs[m][koff .. koff + SK), added into acc[step parity][row group] of warp
// `warp`, which owns rows 16 warp .. + 15 of the tile. The stage's shared
// loads all start before its first product.
template <int NB>
__device__ __forceinline__ void stage_products(const uint8_t* buf,
                                               const __nv_bfloat16* xs, int ldx,
                                               int koff, int warp, int lane,
                                               float (&acc)[2][NB][4]) {
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix.x4: lanes 8 j .. 8 j + 7 give the rows of matrix j: rows
  // 0-7, 8-15, 0-7, 8-15 of the warp's 16, depths 0-7, 0-7, 8-15, 8-15 of
  // the k-step: the A fragment of m16n8k16 in order
  const int r = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t row = mma8::shared_address(buf + r * (SK * 2));
  uint32_t a[STEPS][4], b[STEPS][NB][2];
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int piece = 2 * st + (lane >> 4);
    ldmatrix_x4(a[st], row + ((piece ^ (r & 7)) << 4));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const uint32_t* xr = reinterpret_cast<const uint32_t*>(
          xs + (nb * 8 + g) * ldx + koff + st * 16 + 2 * t);
      b[st][nb][0] = xr[0];
      b[st][nb][1] = xr[4];
    }
  }
#pragma unroll
  for (int st = 0; st < STEPS; ++st)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      mma8::mma_bf16(acc[st & 1][nb], a[st], b[st][nb][0], b[st][nb][1]);
}

template <int NB>
__global__ void __launch_bounds__(THREADS)
rows_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                 const __grid_constant__ CUtensorMap wmap,
                 __nv_bfloat16* __restrict__ y, int rows, int K, int N,
                 int kc, int depth) {
  extern __shared__ uint8_t smem[];
  // the ring's barriers, then the one that counts the peers' partials
  __shared__ __align__(8) uint64_t bars[MAX_DEPTH + 1];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem) + RING_ALIGN - 1) / RING_ALIGN *
      RING_ALIGN);
  // every block of the cluster lays out its shared memory alike (the
  // launch's kc, not the rank's), so a peer's recv is at the same address
  float* recv = reinterpret_cast<float*>(ring + depth * STAGE_BYTES);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(recv + 8 * NB * TN);
  const int ldx = mma8::x_stride((kc + SK - 1) / SK * SK);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = blockIdx.x, ranks = gridDim.x, col0 = blockIdx.y * TN;
  const int per = 8 * NB * TN / ranks;  // a rank's slice of the tile
  const int k0 = min(K, rank * kc), k1 = min(K, k0 + kc);
  const int stages = (k1 - k0 + SK - 1) / SK;
  const int kc_pad = stages * SK;  // zeros of x meet the depths past k1

  if (threadIdx.x == 0) {
    init_barriers(bars, depth);
    // the peers' partials of this block's slice, as bytes to arrive
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     mma8::shared_address(&bars[MAX_DEPTH])),
                 "r"((ranks - 1) * per * (int)sizeof(float))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&wmap))
                 : "memory");
    for (int s = 0; s < min(stages, depth); ++s)
      load_stage(ring, bars, s, depth, &wmap, k0, col0);
  }
  // the next kernel, where launched as a dependent, may start; x may be
  // the kernel before's output: read only after that one has completed
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  mma8::fill_x<NB>(xs, ldx, x, K, 0, rows, k0, k1, kc_pad, threadIdx.x,
                   THREADS);
  mma8::wait_copies<0>();
  __syncthreads();  // the activations are whole, the barriers initialised
  // ... which the peers may count on once they pass the matching wait
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");

  float acc[2][NB][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[p][nb][i] = 0.f;

  for (int s = 0; s < stages; ++s) {
    mma8::wait_barrier(&bars[s % depth], (s / depth) & 1);
    stage_products<NB>(ring + (s % depth) * STAGE_BYTES, xs, ldx, s * SK,
                       warp, lane, acc);
    if (s + depth < stages) {
      __syncthreads();  // stage s is consumed by every warp
      if (threadIdx.x == 0)
        load_stage(ring, bars, s + depth, depth, &wmap, k0, col0);
    }
  }
  __syncthreads();  // every warp is done with the ring: the partial takes it

  // acc[.][nb] = {(row 16 warp + g, x row 8 nb + 2t), (.., 2t + 1),
  // (row + 8, 2t), (row + 8, 2t + 1)}; part[x row][output row of the tile]
  float* part = reinterpret_cast<float*>(ring);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      part[(nb * 8 + 2 * t + (i & 1)) * PART_LD + 16 * warp + g + 8 * (i >> 1)] =
          acc[0][nb][i] + acc[1][nb][i];
  __syncthreads();  // the partial is whole
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");

  // each owner's slice of the partial (outputs o = x row * TN + column,
  // [q per, (q + 1) per) to rank q) into its recv[this rank], 16 bytes a
  // push, counted on its barrier; this rank's own slice stays in `part`
  const uint32_t recv_at = mma8::shared_address(recv + rank * per);
  const uint32_t bar_at = mma8::shared_address(&bars[MAX_DEPTH]);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int o = 4 * (threadIdx.x + j * THREADS), q = o / per;
    if (q != rank)
      push16(peer_address(recv_at + (o - q * per) * sizeof(float), q),
             *reinterpret_cast<const float4*>(&part[o / TN * PART_LD + o % TN]),
             peer_address(bar_at, q));
  }

  // the peers' partials of this block's slice have landed: add them in
  // ascending rank and round once. No peer reads this block's shared
  // memory, and every push into it has landed: the block may leave.
  mma8::wait_barrier(&bars[MAX_DEPTH], 0);
  for (int i = threadIdx.x; i < per; i += THREADS) {
    const int o = rank * per + i, m = o / TN, c = o % TN;
    float sum = 0.f;
    for (int q = 0; q < ranks; ++q)
      sum += q == rank ? part[m * PART_LD + c] : recv[q * per + i];
    if (m < rows && col0 + c < N)
      y[(size_t)m * N + col0 + c] = __float2bfloat16(sum);
  }
}

template <int NB>
cudaError_t launch(const void* x, const CUtensorMap& wmap, void* y, int rows,
                   int K, int N, int ranks, int kc, int depth,
                   cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, (N + TN - 1) / TN, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(NB, (kc + SK - 1) / SK * SK, depth);
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, rows_gemm_kernel<NB>,
                            static_cast<const __nv_bfloat16*>(x), wmap,
                            static_cast<__nv_bfloat16*>(y), rows, K, N, kc,
                            depth);
}

template <int NB>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(rows_gemm_kernel<NB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// Once a device, before the first launch: allow every variant `bytes` of
// dynamic shared memory. Returns the CUDA error (0 on success).
extern "C" int favae_rows_gemm_init(int bytes) {
  cudaError_t err = allow_smem<1>(bytes);
  if (err == cudaSuccess) err = allow_smem<2>(bytes);
  return static_cast<int>(err);
}

// Dynamic shared memory of a block of the plan (nb, kc, depth), in bytes:
// ops/rows_gemm.py's Plan.smem() keeps the same count for its residency
// choice, and the card test holds the two equal.
extern "C" long long favae_rows_gemm_smem(int nb, int kc, int depth) {
  return static_cast<long long>(
      smem_bytes(nb, (kc + SK - 1) / SK * SK, depth));
}

// x (rows, K) bf16, rows <= 8 nb (nb 1 or 2); w (N, K) bf16 row-major,
// 16-byte aligned, K % 8 == 0; y (rows, N) bf16. ranks (the cluster along
// K) 1, 2, 4 or 8, kc a multiple of 64 with ranks * kc >= K, depth the
// ring's stages (1 to MAX_DEPTH). Launched as a programmatic dependent of
// the kernel before on the stream. Returns the CUDA error of the launch (0
// on success; cudaErrorNotSupported where CUDA gives no tensor map).
extern "C" int favae_rows_gemm(const void* x, const void* w, void* y, int rows,
                               int K, int N, int nb, int ranks, int kc,
                               int depth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};  // bytes
  const cuuint32_t box[2] = {(cuuint32_t)SK, (cuuint32_t)TN};
  const cuuint32_t steps[2] = {1, 1};
  auto encode = mma8::encode_tiled();
  if (encode == nullptr ||
      encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
             dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = cudaErrorInvalidValue;
  switch (nb) {
    case 1:
      err = launch<1>(x, wmap, y, rows, K, N, ranks, kc, depth, s);
      break;
    case 2:
      err = launch<2>(x, wmap, y, rows, K, N, ranks, kc, depth, s);
      break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
