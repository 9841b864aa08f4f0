// GroupNorm(+SiLU) backward, first pass: per-(image, channel) sums of g and
// g * xhat, folded into the coefficients of dx, in one launch.
//
// Replaces favae_tpu/ops/gn_pallas.py::_bwd_sums_kernel (line 89) and the
// XLA fold between the two pallas_calls of _gn_act_bwd (lines 219-228). With
// g = dy through the SiLU gradient at ypre = x a + b (or dy alone) and
// xhat = x inv - mean inv, it writes per image n:
//   sums[n] = (sum over rows of g, sum over rows of g xhat)   (2, C)
//   c3[n, c] = -(inv^2) m2 / m,  c2[n, c] = -(inv m1) / m - c3 mean
// with m1 = sum over the group's channels of scale gs, m2 of scale gx and
// m = HW * channels a group (dx = a g + c2 + c3 x, the second pass).
// dscale and dbias are the sums over n of sums[n], one PyTorch sum outside.
//
// Bound: the bytes of x and dy, each read once (at the largest celebahq_expe5
// shape, 16 x 128 x 256^2 bf16, 537 MB: 160 us at 3.35 TB/s). The SiLU
// gradient is ~15 f32 operations and two special-function ones an element,
// under the rate that bound leaves. The design keeps both streams moving and
// does everything else in the same launch:
//   * Work plan (mirrored in ops/gn.py::bwd_sums_plan and block_pieces): a
//     grid of (blocks_per_image, N), a block takes a contiguous range of
//     its image's HW rows (channels_last: a row is C contiguous elements).
//   * Streaming: a producer warp asks for stages of whole rows of x and of
//     dy by 1-D TMA bulk copies (cp.async.bulk, completing on an mbarrier)
//     into a ring of STAGES slots; eight consumer warps take each stage
//     once it has landed and hand the slot back through a second mbarrier,
//     so no block-wide barrier runs inside the stream. A bulk copy wants
//     16-byte aligned addresses and sizes: a stage is a multiple of A =
//     8 / gcd(C, 8) rows, and the fewer than A rows before the first
//     aligned row and after the last whole group of A (C % 8 != 0 only)
//     are read with ordinary loads. No 2-D tensor map: C = 3 in bf16 gives
//     6-byte rows, which no tensor-map stride can describe.
//   * Channel ownership: a consumer thread sums a fixed unit of channels
//     for the whole launch, 8 of them (one 16-byte vector of a 2-byte type)
//     where C % 8 == 0, else one; 256 / units row groups take the rows of a
//     stage in turn. Its sums and its channels' a, b, inv, -mean inv stay
//     in registers.
//   * Finish, no float atomics, the same bits every run: each block adds
//     its row groups in a fixed order and writes one (2, C) partial; thread
//     0 then arrives on its image's integer counter (acquire-release, after
//     a block barrier); the last block of an image to arrive adds the
//     image's partials in block order, writes sums[n] and the fold, and sets
//     the counter back to zero (so that a CUDA graph replays).
// Measured on an H100 (cli/profile_gn_bwd.py's marks): the largest shape
// streams at ~90 % of the bound; a small one (16 x 512 x 16^2) spends ~3.5
// us until its data has landed, ~2.5 us of SiLU arithmetic at one block an
// SM, then ~4 us of finish (partial, arrival, the last block's sums, the
// fold). Loading the constants before the stream, six or three slots, three
// blocks an SM (spills) and asking for the later slots once the first had
// landed were each no faster.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CONSUMERS = 256;            // eight consumer warps
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int STAGES = 4;
constexpr int MAX_BLOCKS = 16;            // blocks an image
constexpr int SMEM_MAX = 160 * 1024;      // dynamic shared memory allowance

// -D GN_BWD_MARKS: thread 0 of each block writes %globaltimer (ns) at the
// steps that cli/profile_gn_bwd.py names; no mark in the kernel's own build
constexpr int MARKS = 8;
constexpr int MARK_BLOCKS = 1 << 14;
#ifdef GN_BWD_MARKS
__device__ unsigned long long g_clock[MARK_BLOCKS * MARKS];
#define MARK(m)                                                              \
  do {                                                                       \
    const int b_ = blockIdx.y * gridDim.x + blockIdx.x;                      \
    if (threadIdx.x == 0 && b_ < MARK_BLOCKS) {                              \
      unsigned long long t_;                                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                 \
      g_clock[b_ * MARKS + (m)] = t_;                                        \
    }                                                                        \
  } while (0)
#else
#define MARK(m) \
  do {          \
  } while (0)
#endif

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

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(shared_address(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(shared_address(bar))
      : "memory");
}

__device__ __forceinline__ int add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// Eight consecutive elements at a 16-byte aligned `p` (shared memory), as f32.
template <typename T>
__device__ __forceinline__ void load8(const void* p, float (&f)[8]) {
  if constexpr (sizeof(T) == 4) {
    const float4 u = reinterpret_cast<const float4*>(p)[0];
    const float4 v = reinterpret_cast<const float4*>(p)[1];
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
    f[4] = v.x; f[5] = v.y; f[6] = v.z; f[7] = v.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        f[2 * i] = __uint_as_float(w[i] << 16);  // a bf16 is an f32's high half
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
        f[2 * i] = h.x;
        f[2 * i + 1] = h.y;
      }
    }
  }
}

// A consumer thread's unit of W channels: its constants and running sums.
template <int W>
struct Unit {
  float a[W], b[W], p[W], q[W];  // ypre = x a + b; xhat = x p + q
  float gs[W], gx[W];
};

template <int W, bool SILU>
__device__ __forceinline__ void accumulate(Unit<W>& u, const float (&x)[W],
                                           const float (&dy)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    float g = dy[i];
    if (SILU) {
      const float ypre = fmaf(x[i], u.a[i], u.b[i]);
      const float s = __fdividef(1.f, 1.f + __expf(-ypre));
      g = g * s * fmaf(ypre, 1.f - s, 1.f);
    }
    u.gs[i] += g;
    u.gx[i] = fmaf(g, fmaf(x[i], u.p[i], u.q[i]), u.gx[i]);
  }
}

struct Args {
  const void* x;
  const void* dy;
  const float* a;      // (N, C)
  const float* b;      // (N, C)
  const float* scale;  // (C,)
  const float* mean;   // (N, G) at strides mean_sn, mean_sg
  const float* inv;    // (N, G) at strides inv_sn, inv_sg
  float* part;         // (N, blocks, 2, C) scratch
  float* sums;         // (N, 2, C)
  float* c2;           // (N, C)
  float* c3;           // (N, C)
  int* counters;       // (N,), zero between launches
  int hw, c, groups, mean_sn, mean_sg, inv_sn, inv_sg;
  int blocks, rows_per_block, stage_rows, fold_at;
};

// The rows of the block's range that start a piece: [r0, hb) head, [hb, te)
// in stages of stage_rows (each a multiple of align rows), [te, r1) tail.
struct Range {
  int r0, r1, hb, te, stages;
};

__device__ __forceinline__ Range block_range(const Args& a, int n, int blk,
                                             int align) {
  Range r;
  r.r0 = blk * a.rows_per_block;
  r.r1 = min(a.hw, r.r0 + a.rows_per_block);
  const long long g0 = (long long)n * a.hw + r.r0;  // the first row, globally
  r.hb = min(r.r1, r.r0 + (int)((align - g0 % align) % align));
  r.te = r.hb + (r.r1 - r.hb) / align * align;
  r.stages = (r.te - r.hb + a.stage_rows - 1) / a.stage_rows;
  return r;
}

// Rows [rb, re) of image n from global memory (head or tail, W == 1 only),
// row group `grp` of `groups_r` taking every groups_r-th.
template <typename XT, typename DT, int W, bool SILU>
__device__ __forceinline__ void consume_global(Unit<W>& u, const Args& a,
                                               size_t img, int rb, int re,
                                               int ch, int grp, int groups_r) {
  const XT* x = static_cast<const XT*>(a.x) + img;
  const DT* dy = static_cast<const DT*>(a.dy) + img;
  for (int r = rb + grp; r < re; r += groups_r) {
    const size_t off = (size_t)r * a.c + ch;
    float xv[W], dv[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      xv[i] = to_f32(x[off + i]);
      dv[i] = to_f32(dy[off + i]);
    }
    accumulate<W, SILU>(u, xv, dv);
  }
}

template <typename XT, typename DT, int W, bool SILU>
__device__ void run(const Args& a, uint8_t* ring, uint64_t* full,
                    uint64_t* empty) {
  const int n = blockIdx.y, blk = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = a.c;
  const int units = C / W;                  // <= CONSUMERS (checked by the host)
  const int groups_r = CONSUMERS / units;   // row groups
  const int low = C & -C;                   // gcd(C, 8) = min(low, 8)
  const int align = 8 / (low < 8 ? low : 8);
  const Range rg = block_range(a, n, blk, align);
  const size_t img = (size_t)n * a.hw * C;  // the image's first element
  const uint32_t xrow = C * sizeof(XT), dyrow = C * sizeof(DT);
  const uint32_t dy_at = a.stage_rows * xrow;
  const uint32_t slot_bytes = a.stage_rows * (xrow + dyrow);

  if (warp == CONSUMERS / 32) {  // the producer warp
    if (lane == 0) {
      const uint8_t* xg = static_cast<const uint8_t*>(a.x) + img * sizeof(XT);
      const uint8_t* dyg = static_cast<const uint8_t*>(a.dy) + img * sizeof(DT);
      for (int k = 0; k < rg.stages; ++k) {
        const int slot = k % STAGES, fill = k / STAGES;
        const int row = rg.hb + k * a.stage_rows;
        const int rows = min(a.stage_rows, rg.te - row);
        if (fill > 0) wait_barrier(&empty[slot], (fill - 1) & 1);
        uint8_t* dst = ring + slot * slot_bytes;
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                shared_address(&full[slot])),
            "r"(rows * (xrow + dyrow))
            : "memory");
        bulk_copy(dst, xg + (size_t)row * xrow, rows * xrow, &full[slot]);
        bulk_copy(dst + dy_at, dyg + (size_t)row * dyrow, rows * dyrow,
                  &full[slot]);
      }
    }
    return;  // the consumers' barriers below count CONSUMERS threads
  }

  const bool active = tid < groups_r * units;
  const int unit = tid % units, grp = tid / units;
  const int ch = unit * W;
  Unit<W> u;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    u.gs[i] = 0.f;
    u.gx[i] = 0.f;
    if (active) {
      const int cg = C / a.groups, g = (ch + i) / cg;
      const float inv = a.inv[n * a.inv_sn + g * a.inv_sg];
      const float mean = a.mean[n * a.mean_sn + g * a.mean_sg];
      u.a[i] = a.a[n * C + ch + i];
      u.b[i] = a.b[n * C + ch + i];
      u.p[i] = inv;
      u.q[i] = -mean * inv;
    }
  }
  // the fold's constants, for the last block of the image: scale, and each
  // group's inv and mean, brought while the first stages land
  float* fold = reinterpret_cast<float*>(ring + a.fold_at);  // [3][C]
  for (int c = tid; c < C; c += CONSUMERS) fold[c] = a.scale[c];
  for (int g = tid; g < a.groups; g += CONSUMERS) {
    fold[C + g] = a.inv[n * a.inv_sn + g * a.inv_sg];
    fold[2 * C + g] = a.mean[n * a.mean_sn + g * a.mean_sg];
  }
  if constexpr (W == 1) {  // the unaligned rows, while the first stages land
    if (active) {
      consume_global<XT, DT, W, SILU>(u, a, img, rg.r0, rg.hb, ch, grp,
                                      groups_r);
      consume_global<XT, DT, W, SILU>(u, a, img, rg.te, rg.r1, ch, grp,
                                      groups_r);
    }
  }
  MARK(0);
  for (int k = 0; k < rg.stages; ++k) {
    const int slot = k % STAGES;
    const int rows = min(a.stage_rows, rg.te - (rg.hb + k * a.stage_rows));
    wait_barrier(&full[slot], (k / STAGES) & 1);
    if (k == 0) MARK(1);
    const uint8_t* xs = ring + slot * slot_bytes;
    const uint8_t* dys = xs + dy_at;
    if (active) {
#pragma unroll 2
      for (int r = grp; r < rows; r += groups_r) {
        float xv[W], dv[W];
        if constexpr (W == 8) {
          load8<XT>(xs + r * xrow + ch * sizeof(XT), xv);
          load8<DT>(dys + r * dyrow + ch * sizeof(DT), dv);
        } else {
          xv[0] = to_f32(reinterpret_cast<const XT*>(xs + r * xrow)[ch]);
          dv[0] = to_f32(reinterpret_cast<const DT*>(dys + r * dyrow)[ch]);
        }
        accumulate<W, SILU>(u, xv, dv);
      }
    }
    __syncwarp();
    if (lane == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                       shared_address(&empty[slot]))
                   : "memory");
  }

  // the block's partial: row groups added in order (the ring is free: every
  // stage has landed and been read once the consumers pass this barrier)
  asm volatile("bar.sync 1, %0;" ::"r"(CONSUMERS) : "memory");
  MARK(2);
  float* red = reinterpret_cast<float*>(ring);  // [2][groups_r][C]
  if (active) {
    if constexpr (W == 8) {  // 16-byte stores: fewer bank conflicts
      float4* gs = reinterpret_cast<float4*>(red + grp * C + ch);
      float4* gx = reinterpret_cast<float4*>(red + (groups_r + grp) * C + ch);
      gs[0] = make_float4(u.gs[0], u.gs[1], u.gs[2], u.gs[3]);
      gs[1] = make_float4(u.gs[4], u.gs[5], u.gs[6], u.gs[7]);
      gx[0] = make_float4(u.gx[0], u.gx[1], u.gx[2], u.gx[3]);
      gx[1] = make_float4(u.gx[4], u.gx[5], u.gx[6], u.gx[7]);
    } else {
      red[grp * C + ch] = u.gs[0];
      red[(groups_r + grp) * C + ch] = u.gx[0];
    }
  }
  asm volatile("bar.sync 1, %0;" ::"r"(CONSUMERS) : "memory");
  float* part = a.part + ((size_t)n * a.blocks + blk) * 2 * C;
  for (int c = tid; c < C; c += CONSUMERS) {
    float s1 = 0.f, s2 = 0.f;
    for (int g = 0; g < groups_r; ++g) {
      s1 += red[g * C + c];
      s2 += red[(groups_r + g) * C + c];
    }
    part[c] = s1;
    part[C + c] = s2;
  }
  __shared__ int last;
  asm volatile("bar.sync 1, %0;" ::"r"(CONSUMERS) : "memory");
  MARK(3);
  if (tid == 0) last = add_acq_rel(&a.counters[n], 1) == a.blocks - 1;
  MARK(4);
  asm volatile("bar.sync 1, %0;" ::"r"(CONSUMERS) : "memory");
  if (!last) return;  // thread 0's acquire and the barrier order the loads

  // the last block of image n: its sums, in block order, then the fold
  float* fin = red;  // [2][C]
  const float* ip = a.part + (size_t)n * a.blocks * 2 * C;
  for (int c = tid; c < C; c += CONSUMERS) {
    float v1[MAX_BLOCKS], v2[MAX_BLOCKS];  // every load in flight at once
#pragma unroll
    for (int k = 0; k < MAX_BLOCKS; ++k) {
      const int kk = min(k, a.blocks - 1);
      v1[k] = __ldcg(ip + (size_t)kk * 2 * C + c);
      v2[k] = __ldcg(ip + (size_t)kk * 2 * C + C + c);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_BLOCKS; ++k)
      if (k < a.blocks) {
        s1 += v1[k];
        s2 += v2[k];
      }
    fin[c] = s1;
    fin[C + c] = s2;
    a.sums[(size_t)n * 2 * C + c] = s1;
    a.sums[(size_t)n * 2 * C + C + c] = s2;
  }
  asm volatile("bar.sync 1, %0;" ::"r"(CONSUMERS) : "memory");
  MARK(5);
  const int cg = C / a.groups;
  const float m = (float)a.hw * (float)cg;
  // a group's m1, m2 over L lanes (the power of two >= cg, at most 32), so
  // that 32 / L groups share a warp; every lane of a warp takes each pass
  int lanes = 1;
  while (lanes < cg && lanes < 32) lanes <<= 1;
  const int per_warp = 32 / lanes, sub = lane / lanes, sl = lane % lanes;
  const int per_pass = CONSUMERS / 32 * per_warp;
  for (int g0 = 0; g0 < a.groups; g0 += per_pass) {
    const int g = g0 + warp * per_warp + sub;
    float m1 = 0.f, m2 = 0.f;
    if (g < a.groups)
      for (int j = sl; j < cg; j += lanes) {
        const float s = fold[g * cg + j];
        m1 += s * fin[g * cg + j];
        m2 += s * fin[C + g * cg + j];
      }
    for (int off = lanes / 2; off > 0; off >>= 1) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, off);
      m2 += __shfl_xor_sync(0xffffffffu, m2, off);
    }
    if (g < a.groups) {
      const float inv = fold[C + g], mean = fold[2 * C + g];
      const float c3 = -(inv * inv) * m2 / m;
      const float c2 = -(inv * m1) / m - c3 * mean;
      for (int j = sl; j < cg; j += lanes) {
        a.c2[(size_t)n * C + g * cg + j] = c2;
        a.c3[(size_t)n * C + g * cg + j] = c3;
      }
    }
  }
  MARK(6);
  if (tid == 0) a.counters[n] = 0;  // ready for the next launch
}

template <typename XT, typename DT>
__global__ void __launch_bounds__(THREADS, 2)
gn_bwd_sums_kernel(const Args a, int vec, int silu) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       shared_address(&full[i]))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       shared_address(&empty[i])),
                   "r"(CONSUMERS / 32)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  MARK(7);
  if (vec) {
    if (silu) run<XT, DT, 8, true>(a, ring, full, empty);
    else run<XT, DT, 8, false>(a, ring, full, empty);
  } else {
    if (silu) run<XT, DT, 1, true>(a, ring, full, empty);
    else run<XT, DT, 1, false>(a, ring, full, empty);
  }
}

using Kernel = void (*)(const Args, int, int);

// dtype codes: 0 bf16, 1 f16, 2 f32
template <typename XT>
Kernel pick_dy(int dyt) {
  switch (dyt) {
    case 0: return gn_bwd_sums_kernel<XT, __nv_bfloat16>;
    case 1: return gn_bwd_sums_kernel<XT, __half>;
    case 2: return gn_bwd_sums_kernel<XT, float>;
  }
  return nullptr;
}

Kernel pick(int xt, int dyt) {
  switch (xt) {
    case 0: return pick_dy<__nv_bfloat16>(dyt);
    case 1: return pick_dy<__half>(dyt);
    case 2: return pick_dy<float>(dyt);
  }
  return nullptr;
}

}  // namespace

#ifdef GN_BWD_MARKS
// The marks of the last launch into `host` (MARK_BLOCKS * MARKS), or zero
// them (zero != 0). Returns the CUDA error.
extern "C" int favae_gn_bwd_clock(void* host, int zero) {
  static unsigned long long z[MARK_BLOCKS * MARKS];
  return static_cast<int>(zero ? cudaMemcpyToSymbol(g_clock, z, sizeof(z))
                               : cudaMemcpyFromSymbol(host, g_clock,
                                                      sizeof(z)));
}
#endif

// Once a device, before the first launch: allow every instantiation its
// dynamic shared memory. Returns the CUDA error (0 on success).
extern "C" int favae_gn_bwd_sums_init() {
  for (int xt = 0; xt < 3; ++xt)
    for (int dyt = 0; dyt < 3; ++dyt) {
      const cudaError_t err = cudaFuncSetAttribute(
          pick(xt, dyt), cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  return 0;
}

// The kernel's constants, for the host's plan: threads, consumer threads,
// stages, blocks an image at most, shared memory allowance.
extern "C" void favae_gn_bwd_sums_layout(int* out) {
  out[0] = THREADS;
  out[1] = CONSUMERS;
  out[2] = STAGES;
  out[3] = MAX_BLOCKS;
  out[4] = SMEM_MAX;
}

// x, dy (N, HW, C) in bf16/f16/f32 (codes xt, dyt), 16-byte aligned; a, b
// (N, C), scale (C,), mean and inv (N, G) at the given element strides, all
// f32; part (N, blocks, 2, C) f32 scratch; sums (N, 2, C), c2 and c3 (N, C)
// f32 out; counters (N,) int, zero before the launch (and after it). The
// plan (blocks, rows_per_block, stage_rows, fold_at, smem) comes from
// ops/gn.py::bwd_sums_plan. Returns the CUDA error of the launch.
extern "C" int favae_gn_bwd_sums(
    const void* x, const void* dy, const void* a, const void* b,
    const void* scale, const void* mean, const void* inv, void* part,
    void* sums, void* c2, void* c3, void* counters, int n, int hw, int c,
    int groups, int mean_sn, int mean_sg, int inv_sn, int inv_sg, int blocks,
    int rows_per_block, int stage_rows, int fold_at, int smem, int xt,
    int dyt, int silu, void* stream) {
  const Kernel k = pick(xt, dyt);
  if (k == nullptr || blocks > MAX_BLOCKS || smem > SMEM_MAX ||
      fold_at + 3 * c * (int)sizeof(float) > smem)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.x = x;
  args.dy = dy;
  args.a = static_cast<const float*>(a);
  args.b = static_cast<const float*>(b);
  args.scale = static_cast<const float*>(scale);
  args.mean = static_cast<const float*>(mean);
  args.inv = static_cast<const float*>(inv);
  args.part = static_cast<float*>(part);
  args.sums = static_cast<float*>(sums);
  args.c2 = static_cast<float*>(c2);
  args.c3 = static_cast<float*>(c3);
  args.counters = static_cast<int*>(counters);
  args.hw = hw;
  args.c = c;
  args.groups = groups;
  args.mean_sn = mean_sn;
  args.mean_sg = mean_sg;
  args.inv_sn = inv_sn;
  args.inv_sg = inv_sg;
  args.blocks = blocks;
  args.rows_per_block = rows_per_block;
  args.stage_rows = stage_rows;
  args.fold_at = fold_at;
  k<<<dim3(blocks, n), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      args, c % 8 == 0, silu);
  return static_cast<int>(cudaGetLastError());
}
