// One token through all L layers of the CAT transformer in one launch.
//
// Replaces favae_tpu/ops/decode_step_kernel.py::decode_step_fused (body
// _decode_kernel), which walks a sequential grid (L, phases) with the hidden
// state, q and the accumulators in scratch memory. On the card the same
// one-launch-a-token function is a persistent cooperative kernel: every block
// stays resident, the phases of a layer follow each other with a barrier
// across the whole grid (cooperative_groups grid.sync()) between them, and
// inside a phase the work is cut into items that the blocks deal among
// themselves. Per layer, 11 phases:
//    1  q projection of LN(x) (int8 W_q), and kv_t (bf16 W_kv)
//    2  self-attention, one item per (row, head); kv_t enters the cache
//    3  out projection                             (int8)
//    4  one block a row: x += LN(of), xn = LN(x)
//    5  cross q projection   6  cross-attention   7  out projection
//    8  one block a row: x += LN(of), xn = LN(x)
//    9  fc1 (int8); the last item of a column tile to finish adds the tile's
//       partials, applies GELU and keeps h (bf16) and its row sums
//   10  fc2 of h, mid LayerNorm folded             (int8, gamma-folded)
//   11  one block a row: x += inv * (acc * s2 - mu * c2), xn for the next
//       layer, or the bf16 store of x after the last one
// Bound: the bytes of all layers' weights (about 0.6 GB a token at
// gpt2_medium). What the design does about the rest:
//   * The six int8 products run on the tensor cores (int8_mma.cuh's
//     stage_products: mma.sync m16n8k16 on the transposed problem, the 8 rows
//     the n = 8 side, int8 -> bf16 exact) over weight tiles that TMA brings
//     in boxes of 64 rows x 128 columns through 3-D tensor maps of the
//     (L, K, N) stacks. A block of 256 threads, one an SM, is two workers of
//     128, each with its own ring of RING boxes and named barrier; a worker
//     takes an item (128 columns x a chunk of K of at most RING boxes).
//   * Weights do not depend on activations, so a worker asks for its next
//     product's boxes as soon as its ring is free, before the grid barriers
//     and the attention or row phases in between: the rings of the grid
//     (some 13 MB) hold a whole product, whose bytes stream while the phases
//     before it run.
//   * One block an SM leaves a thread all 255 registers: at two blocks an SM
//     (128 registers) the spills cost 0.3 ms a token on an H100. Inside the
//     launch, a dependent trip to L2 costs ~0.65 us, so every sum over
//     chunks or tiles starts all of its loads before the first add.
//   * Partial products of the chunks of K go to an f32 scratch (in L2) and
//     are added in ascending chunk order by whoever consumes them; no float
//     atomics, so the same inputs give the same bits. The integer arrival
//     counters of fc1 only elect the item that adds a tile's chunks.
//
// Each (row, head) attends its own [null | cache[:pos + 1]] directly; the
// cache row `pos` is written in place by the head-0 item of its row, and the
// other heads of that row use the same bf16 values from shared memory, so no
// item reads a cache row that another block writes in the same launch. Cache
// rows beyond pos are neither read nor trusted.
//
// The position is a device scalar, as the TPU kernel's SMEM `pos`, so that a
// CUDA graph of the token step serves every position: every block reads it
// once at entry and passes it to its self-attention items. One outside
// [0, S) adds one to the error word and the launch writes nothing (no cache
// row, no x); the caller reads the word later.
#include <cooperative_groups.h>

#include "int8_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace favae;

constexpr int DH = 64;                 // head width the attention items take
constexpr int WT = mma8::THREADS;      // threads of a worker: 128
constexpr int WORKERS = THREADS / WT;  // workers of a block: 2
constexpr int RING = 6;                // boxes of a worker's ring
constexpr int RING_BYTES = RING * mma8::STAGE_BYTES;
constexpr int KC_MAX = RING * mma8::SK;  // the longest chunk of K: 384 rows
constexpr int NPROD = 6;
constexpr int PHASES = 11;             // of a layer, a grid barrier after each
constexpr int KV_UNROLL = 16;          // W_kv rows in flight a warp
// dynamic shared memory the kernel is allowed, set once whatever the shapes
constexpr size_t SMEM_ALLOWED = 160 * 1024;

// the int8 products of a layer, in order
enum { P_QS, P_OS, P_QC, P_OC, P_FC1, P_FC2 };

struct DecodeParams {
  const __nv_bfloat16* x;         // (rows, d)
  __nv_bfloat16* caches;          // (L, rows, S, DH); row pos written in place
  const __nv_bfloat16* cross_kv;  // (L, rows, M, DH), slot 0 the null kv
  const float* cross_bias;        // (rows, M)
  const float* rel_rows;          // (L, heads, S + 1)
  const float* sq_s;              // (L, inner)
  const float* so_s;              // (L, d)
  const float* sq_c;
  const float* so_c;
  const __nv_bfloat16* wkv;       // (L, d, DH)
  const float* null_kv;           // (L, DH)
  const float* norms;             // (L, 5, d)
  const float* s1;                // (L, F)
  const float* s2;                // (L, d)
  const float* c2;                // (L, d)
  __nv_bfloat16* x_out;           // (rows, d)
  float* scratch;
  unsigned long long* clock;      // 2 (1 + 11 L) times in ns (barrier), or null
  const long long* pos;           // () int64: the cache row this step writes
  int* error;                     // () int32: += 1 a launch given a bad pos
  int L, rows, d, heads, S, M, F;
  int kc[NPROD];                  // chunk of K of each product
  float eps;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) / 4 * 4; }
template <typename T>
__host__ __device__ inline T larger(T a, T b) { return a > b ? a : b; }
template <typename T>
__host__ __device__ inline T smaller(T a, T b) { return a < b ? a : b; }

// Ask L2 to fetch `bytes` (a multiple of 16) at a 16-byte aligned global
// address, a hint with no effect on results (one instruction, no waiting).
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  if (bytes > 0)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The grid barrier after phase n, timed for favae_tpu_torch/cli/
// profile_decode.py when `clock` is given: clock[n] is when block 0 passed
// it, clock[phases + n] the latest time a block reached it (its work in the
// phase done), so the two split a phase into work and barrier. After the
// last phase there is no barrier, only the times.
__device__ __forceinline__ void grid_barrier(cg::grid_group& grid,
                                             const DecodeParams& p,
                                             int phases, int& n,
                                             bool sync = true) {
  if (p.clock != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) atomicMax(&p.clock[phases + n], global_ns());
  }
  if (sync) grid.sync();
  if (p.clock != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    p.clock[n] = global_ns();
  ++n;
}

// Offsets of the scratch segments, in floats (16-byte aligned). bf16 arrays
// take half a float an element, the arrival counters one.
struct Scratch {
  size_t xst, xn, ao, h, part_q, part_kv, part_o, part1, part2, hstat, cnt,
      total;
};

__host__ __device__ inline Scratch scratch_layout(int rows, int d, int inner,
                                                  int F, int kc_q, int kc_o,
                                                  int kc_1, int kc_2) {
  Scratch s;
  size_t o = 0;
  s.xst = o;      o += pad4((size_t)rows * d);            // f32 state
  s.xn = o;       o += pad4((size_t)rows * d / 2);        // bf16 LN(x)
  s.ao = o;       o += pad4((size_t)rows * inner / 2);    // bf16 attention
  s.h = o;        o += pad4((size_t)rows * F / 2);        // bf16 gelu(fc1)
  s.part_q = o;   o += pad4((size_t)cdiv(d, kc_q) * rows * inner);
  s.part_kv = o;  o += pad4((size_t)cdiv(d, kc_q) * rows * DH);
  s.part_o = o;   o += pad4((size_t)cdiv(inner, kc_o) * rows * d);
  s.part1 = o;    o += pad4((size_t)cdiv(d, kc_1) * rows * F);
  s.part2 = o;    o += pad4((size_t)cdiv(F, kc_2) * rows * d);
  s.hstat = o;    o += pad4((size_t)(F / TN) * rows * 2);  // sum h, h^2
  s.cnt = o;      o += pad4((size_t)(rows / MR) * (F / TN));
  s.total = o;
  return s;
}

// Bytes of a worker's own shared memory: the item's bf16 activations and the
// fc1 finish's row sums, or the kv items' f32 activations and warp sums.
__host__ __device__ inline int worker_bytes(int kc_q) {
  const int mma = 8 * mma8::x_stride(KC_MAX) * 2 + 4 * MR * 2 * 4;
  const int kv = (kc_q * MR + 4 * MR * DH) * 4;
  return (larger(mma, kv) + 127) / 128 * 128;
}

// Dynamic shared memory: room to align the rings, the two rings, then the
// two workers' own regions, which the block-wide phases (attention, rows)
// use as one region between barriers.
__host__ __device__ inline size_t smem_bytes(int d, int S, int M, int kc_q) {
  const size_t rows_phase = (size_t)(d + WARPS) * 4;
  const size_t attn =
      (size_t)((3 + WARPS) * DH + WARPS + larger(S + 1, M)) * 4;
  const size_t own = (size_t)WORKERS * worker_bytes(kc_q);
  return mma8::RING_ALIGN + (size_t)WORKERS * RING_BYTES +
         larger(own, larger(rows_phase, attn));
}

// One worker: 128 threads of a block with their own ring of weight boxes,
// named barrier and shared memory. `seq` counts the boxes the worker has
// consumed; box n lands in slot n % RING, in the phase n / RING of its
// mbarrier, for the whole launch (the ring is reused across products and
// layers, so the parity is carried, never reset).
struct Worker {
  int id, nworkers, tid, half;
  uint8_t* ring;
  uint64_t* bars;
  uint8_t* own;
  uint32_t seq;

  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + half), "r"(WT) : "memory");
  }
};

// What an int8 product multiplies: x (rows, K) bf16 in scratch times the
// layer's (K, N) matrix behind maps[P], partials (chunks, rows, N) f32.
struct Prod {
  int K, N, kc;
  const __nv_bfloat16* x;
  float* part;
};

__device__ __forceinline__ Prod product(const DecodeParams& p,
                                        const Scratch& sc, int P) {
  float* scr = p.scratch;
  const int inner = p.heads * DH;
  const auto* xn = reinterpret_cast<const __nv_bfloat16*>(scr + sc.xn);
  switch (P) {
    case P_QS:
    case P_QC:
      return {p.d, inner, p.kc[P], xn, scr + sc.part_q};
    case P_OS:
    case P_OC:
      return {inner, p.d, p.kc[P],
              reinterpret_cast<const __nv_bfloat16*>(scr + sc.ao),
              scr + sc.part_o};
    case P_FC1:
      return {p.d, p.F, p.kc[P], xn, scr + sc.part1};
    default:
      return {p.F, p.d, p.kc[P],
              reinterpret_cast<const __nv_bfloat16*>(scr + sc.h),
              scr + sc.part2};
  }
}

// Item `it` of a (K, N) product cut into chunks of kc rows of K: column
// tile fastest, then chunk of K, then row group. N is a multiple of 64: the
// last tile's columns past N arrive as zeros and are not stored.
struct Item {
  int tile, chunk, group, k0, k1, stages;
};

__host__ __device__ inline Item item_of(int K, int N, int kc, int it) {
  const int tiles = cdiv(N, TN), nch = cdiv(K, kc);
  Item t;
  t.tile = it % tiles;
  t.chunk = it / tiles % nch;
  t.group = it / (tiles * nch);
  t.k0 = t.chunk * kc;
  t.k1 = smaller(K, t.k0 + kc);
  t.stages = cdiv(t.k1 - t.k0, mma8::SK);
  return t;
}

__host__ __device__ inline int items_of(int K, int N, int kc, int rows) {
  return cdiv(N, TN) * cdiv(K, kc) * (rows / MR);
}

__device__ __forceinline__ Item item_of(const Prod& pr, int it) {
  return item_of(pr.K, pr.N, pr.kc, it);
}

__device__ __forceinline__ int items_of(const Prod& pr, int rows) {
  return items_of(pr.K, pr.N, pr.kc, rows);
}

// Boxes [from, to) of an item, by the worker's thread 0; the item's first
// box is box `seq` of the worker.
__device__ __forceinline__ void issue(const Worker& w, const CUtensorMap* map,
                                      int layer, const Item& t, int from,
                                      int to) {
  for (int s = from; s < to; ++s) {
    const uint32_t n = w.seq + s;
    mma8::issue_box3(w.ring + (n % RING) * mma8::STAGE_BYTES,
                     &w.bars[n % RING], map, t.tile * TN, t.k0 + s * mma8::SK,
                     layer);
  }
}

// The first boxes of the worker's first item of product P of layer l, asked
// for while the ring is free, before the phases in between have run.
__device__ __forceinline__ void prefetch(const DecodeParams& p,
                                         const Scratch& sc,
                                         const CUtensorMap* const* maps,
                                         const Worker& w, int P, int l) {
  if (l >= p.L || w.tid != 0) return;
  const Prod pr = product(p, sc, P);
  if (w.id >= items_of(pr, p.rows)) return;
  const Item t = item_of(pr, w.id);
  issue(w, maps[P], l, t, 0, min(t.stages, RING));
}

// fc1's epilogue: the last item of a (row group, column tile) to arrive adds
// the tile's chunks in ascending order, h = gelu(sum * s1) goes to scratch as
// bf16, and the tile's f32 row sums of h and h^2 (before the rounding) to
// hstat. Thread `tid` takes column tid of the tile for the 8 rows.
__device__ void fc1_finish(const DecodeParams& p, const Scratch& sc,
                           const Worker& w, const Prod& pr, const Item& t,
                           int l, int* flag) {
  float* scr = p.scratch;
  const int tiles = pr.N / TN, nch = cdiv(pr.K, pr.kc);
  int* cnt = reinterpret_cast<int*>(scr + sc.cnt) + t.group * tiles + t.tile;
  __threadfence();  // this thread's partial is visible before the count
  w.sync();
  if (w.tid == 0) flag[w.half] = atomicAdd(cnt, 1) == (l + 1) * nch - 1;
  w.sync();
  if (!flag[w.half]) return;
  __threadfence();
  const int col = t.tile * TN + w.tid, r0 = t.group * MR;
  const size_t chunk = (size_t)p.rows * p.F;
  const float* src = pr.part + (size_t)r0 * p.F + col;
  float a[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) a[m] = 0.f;
  for (int c0 = 0; c0 < nch; c0 += 8) {  // 64 loads in flight
    float v[8][MR];
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int m = 0; m < MR; ++m)
        v[c][m] = __ldcg(src + min(c0 + c, nch - 1) * chunk + (size_t)m * p.F);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c0 + c < nch) {
#pragma unroll
        for (int m = 0; m < MR; ++m) a[m] += v[c][m];
      }
  }
  const float s1 = p.s1[(size_t)l * p.F + col];
  auto* h = reinterpret_cast<__nv_bfloat16*>(scr + sc.h);
  float* red = reinterpret_cast<float*>(w.own + 8 * mma8::x_stride(KC_MAX) * 2);
  const int warp = w.tid >> 5, lane = w.tid & 31;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const float hv = gelu_tanh(a[m] * s1);
    h[(size_t)(r0 + m) * p.F + col] = __float2bfloat16(hv);
    const float s = warp_sum(hv), q = warp_sum(hv * hv);
    if (lane == 0) {
      red[(warp * MR + m) * 2] = s;
      red[(warp * MR + m) * 2 + 1] = q;
    }
  }
  w.sync();
  if (w.tid < 2 * MR) {
    const int m = w.tid / 2, k = w.tid % 2;
    float v = 0.f;
#pragma unroll
    for (int ww = 0; ww < 4; ++ww) v += red[(ww * MR + m) * 2 + k];
    scr[sc.hstat + ((size_t)t.tile * p.rows + r0 + m) * 2 + k] = v;
  }
}

// All of a worker's items of int8 product P of layer l, then the prefetch of
// the next product. The worker's first item was prefetched before.
__device__ void proj_phase(const DecodeParams& p, const Scratch& sc,
                           const CUtensorMap* const* maps, Worker& w, int P,
                           int l, int* flag) {
  const Prod pr = product(p, sc, P);
  const int items = items_of(pr, p.rows);
  const int warp = w.tid >> 5, lane = w.tid & 31, g = lane >> 2, tq = lane & 3;
  auto* xs = reinterpret_cast<__nv_bfloat16*>(w.own);
  for (int it = w.id; it < items; it += w.nworkers) {
    const Item t = item_of(pr, it);
    if (it != w.id && w.tid == 0) issue(w, maps[P], l, t, 0, min(t.stages, RING));
    const int kc_pad = t.stages * mma8::SK;
    const int ldx = mma8::x_stride(kc_pad);
    mma8::fill_x<1>(xs, ldx, pr.x, pr.K, t.group * MR, MR, t.k0, t.k1, kc_pad,
                    w.tid, WT);
    mma8::wait_copies<0>();
    w.sync();  // the activations are whole
    float acc[2][1][2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][0][hh][i] = 0.f;
    for (int s = 0; s < t.stages; ++s) {
      const uint32_t n = w.seq + s;
      mma8::wait_barrier(&w.bars[n % RING], (n / RING) & 1);
      mma8::stage_products<1>(w.ring + (n % RING) * mma8::STAGE_BYTES, xs, ldx,
                              s * mma8::SK, warp, lane, acc);
      if (s + RING < t.stages) {
        w.sync();  // box s is consumed by every warp
        if (w.tid == 0) issue(w, maps[P], l, t, s + RING, s + RING + 1);
      }
    }
    w.seq += t.stages;
    // acc[.][0][h] = {(col 4g+2h, row 2t), (4g+2h, 2t+1), (4g+2h+1, 2t),
    // (4g+2h+1, 2t+1)}
    const int col = t.tile * TN + warp * 32 + g * 4;
    float* out = pr.part + ((size_t)t.chunk * p.rows + t.group * MR) * pr.N +
                 col;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (col < pr.N)
        *reinterpret_cast<float4*>(out + (size_t)(2 * tq + r) * pr.N) =
            make_float4(acc[0][0][0][r] + acc[1][0][0][r],
                        acc[0][0][0][2 + r] + acc[1][0][0][2 + r],
                        acc[0][0][1][r] + acc[1][0][1][r],
                        acc[0][0][1][2 + r] + acc[1][0][1][2 + r]);
    if (P == P_FC1) fc1_finish(p, sc, w, pr, t, l, flag);
    w.sync();  // the ring and xs are free
  }
  if (P == P_FC2)
    prefetch(p, sc, maps, w, P_QS, l + 1);
  else
    prefetch(p, sc, maps, w, P + 1, l);
}

// kv_t = xn @ W_kv (bf16 weights, DH columns) on the CUDA cores, items (row
// group, chunk of d) taken by the workers from the last one down (the q
// items go from the first up); a lane owns 2 columns, the 4 warps every 4th
// row of the chunk. part_kv (chunks, rows, DH).
__device__ void kv_phase(const DecodeParams& p, const Scratch& sc,
                         const Worker& w, int l) {
  const int d = p.d, kc = p.kc[P_QS], nch = cdiv(d, kc);
  const int items = p.rows / MR * nch;
  const int warp = w.tid >> 5, lane = w.tid & 31;
  const auto* xn = reinterpret_cast<const __nv_bfloat16*>(p.scratch + sc.xn);
  const __nv_bfloat16* wkv = p.wkv + (size_t)l * d * DH;
  float* xs = reinterpret_cast<float*>(w.own);  // [k][row]
  float* red = xs + kc * MR;                    // [warp][row][col]
  for (int it = w.nworkers - 1 - w.id; it < items; it += w.nworkers) {
    const int c = it % nch, r0 = it / nch * MR;
    const int k0 = c * kc, k1 = min(d, k0 + kc), n = k1 - k0;
    for (int i0 = w.tid; i0 < n * MR; i0 += 8 * WT) {  // 8 loads in flight
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = min(i0 + u * WT, n * MR - 1);
        v[u] = __bfloat162float(xn[(size_t)(r0 + i / n) * d + k0 + i % n]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * WT;
        if (i < n * MR) xs[(i % n) * MR + i / n] = v[u];
      }
    }
    w.sync();
    float acc[MR][2];
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[m][0] = acc[m][1] = 0.f;
    const __nv_bfloat162* wl =
        reinterpret_cast<const __nv_bfloat162*>(wkv + lane * 2);
    for (int kb = k0 + warp; kb < k1; kb += 4 * KV_UNROLL) {
      __nv_bfloat162 wv[KV_UNROLL];  // rows past the chunk repeat its last row
#pragma unroll
      for (int u = 0; u < KV_UNROLL; ++u)
        wv[u] = wl[(size_t)min(kb + 4 * u, k1 - 1) * (DH / 2)];
#pragma unroll
      for (int u = 0; u < KV_UNROLL; ++u) {
        const int k = kb + 4 * u;
        if (k >= k1) break;
        const float w0 = __low2float(wv[u]), w1 = __high2float(wv[u]);
        const float* xk = xs + (k - k0) * MR;
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          acc[m][0] = fmaf(xk[m], w0, acc[m][0]);
          acc[m][1] = fmaf(xk[m], w1, acc[m][1]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      red[(warp * MR + m) * DH + lane * 2] = acc[m][0];
      red[(warp * MR + m) * DH + lane * 2 + 1] = acc[m][1];
    }
    w.sync();
    for (int o = w.tid; o < MR * DH; o += WT) {
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < 4; ++ww) s += red[ww * MR * DH + o];
      p.scratch[sc.part_kv + ((size_t)c * p.rows + r0 + o / DH) * DH + o % DH] = s;
    }
    if (w.tid == 0 && l + 1 < p.L)  // the same rows of the next layer
      prefetch_l2(wkv + (size_t)d * DH + (size_t)k0 * DH, n * DH * 2);
    w.sync();
  }
}

// The kv items' rows of W_kv of layer l into L2, by the workers that take
// them (the kv phase asks for the next layer's itself).
__device__ __forceinline__ void prefetch_kv(const DecodeParams& p,
                                            const Worker& w, int l) {
  const int d = p.d, kc = p.kc[P_QS], nch = cdiv(d, kc);
  if (w.tid != 0) return;
  for (int it = w.nworkers - 1 - w.id; it < p.rows / MR * nch;
       it += w.nworkers) {
    const int k0 = it % nch * kc;
    prefetch_l2(p.wkv + ((size_t)l * d + k0) * DH, (min(d, k0 + kc) - k0) * DH * 2);
  }
}

// One (row, head) of attention by one block. q is rebuilt from its partial
// products; slot j of the keys/values is, for self-attention, the null kv
// (j = 0), cache row j - 1 (1 <= j <= pos) or the new row kv_t (j = pos + 1),
// and for cross-attention row j of the precomputed text kv. Scores, bias and
// softmax in f32; q, the probabilities and the output rounded to bf16 where
// the TPU kernel rounds them.
template <bool SELF>
__device__ void attend_item(const DecodeParams& p, const Scratch& sc, int l,
                            int row, int head, float* sm, const int pos) {
  const int inner = p.heads * DH;
  const int tid = threadIdx.x;
  float* qs = sm;               // DH
  float* kv_null = sm + DH;     // DH
  float* kv_new = sm + 2 * DH;  // DH
  float* sh = sm + 3 * DH;      // WARPS
  float* og = sm + 3 * DH + WARPS;    // WARPS x DH
  float* pr = og + WARPS * DH;        // n_slots scores, then probabilities
  const int n_slots = SELF ? pos + 2 : p.M;
  const int nkq = cdiv(p.d, p.kc[P_QS]);
  const float* scr = p.scratch;

  if (tid < DH) {
    const int col = head * DH + tid;
    const float a = sum_strided<32>(
        scr + sc.part_q + (size_t)row * inner + col, (size_t)p.rows * inner, nkq);
    const float* sq = (SELF ? p.sq_s : p.sq_c) + (size_t)l * inner;
    qs[tid] = bf16_round(a * sq[col] * 0.125f);  // DH^-0.5
  } else if (SELF && tid < 2 * DH) {
    const int dd = tid - DH;
    const float a = sum_strided<32>(scr + sc.part_kv + (size_t)row * DH + dd,
                                 (size_t)p.rows * DH, nkq);
    const __nv_bfloat16 v = __float2bfloat16(a);
    kv_new[dd] = __bfloat162float(v);
    if (head == 0)
      p.caches[(((size_t)l * p.rows + row) * p.S + pos) * DH + dd] = v;
  } else if (SELF && tid < 3 * DH) {
    const int dd = tid - 2 * DH;
    kv_null[dd] = bf16_round(p.null_kv[(size_t)l * DH + dd]);
  }
  __syncthreads();

  const __nv_bfloat16* kv =
      SELF ? p.caches + ((size_t)l * p.rows + row) * p.S * DH
           : p.cross_kv + ((size_t)l * p.rows + row) * p.M * DH;
  const float* bias = SELF
      ? p.rel_rows + ((size_t)l * p.heads + head) * (p.S + 1)
      : p.cross_bias + (size_t)row * p.M;

  float mx = -3.0e38f;
  for (int j = tid; j < n_slots; j += THREADS) {
    float s = 0.f;
    if (SELF && (j == 0 || j == pos + 1)) {
      const float* src = j == 0 ? kv_null : kv_new;
#pragma unroll 8
      for (int dd = 0; dd < DH; ++dd) s = fmaf(qs[dd], src[dd], s);
    } else {
      const uint4* src = reinterpret_cast<const uint4*>(
          kv + (size_t)(SELF ? j - 1 : j) * DH);
#pragma unroll
      for (int v = 0; v < DH / 8; ++v) {
        const uint4 u = src[v];
        const uint32_t wds[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a bf16 is the high half of its f32
          s = fmaf(qs[v * 8 + e * 2], __uint_as_float(wds[e] << 16), s);
          s = fmaf(qs[v * 8 + e * 2 + 1],
                   __uint_as_float(wds[e] & 0xffff0000u), s);
        }
      }
    }
    s += bias[j];
    pr[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_max(mx, sh);
  float sum = 0.f;
  for (int j = tid; j < n_slots; j += THREADS) {
    const float e = expf(pr[j] - mx);
    pr[j] = e;
    sum += e;
  }
  sum = block_sum(sum, sh);
  for (int j = tid; j < n_slots; j += THREADS) pr[j] = bf16_round(pr[j] / sum);
  __syncthreads();

  // p @ v: warp g takes every 8th slot, a lane two neighbouring dims; eight
  // slots' loads in flight, the order of the additions fixed
  const int d2 = 2 * (tid & 31), grp = tid >> 5;
  auto kv_at = [&](int j) -> float2 {
    if (SELF && j == 0) return make_float2(kv_null[d2], kv_null[d2 + 1]);
    if (SELF && j == pos + 1) return make_float2(kv_new[d2], kv_new[d2 + 1]);
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        kv + (size_t)(SELF ? j - 1 : j) * DH + d2));
  };
  float2 o8[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o8[e] = make_float2(0.f, 0.f);
  int j = grp;
  for (; j + 7 * WARPS < n_slots; j += 8 * WARPS) {
    float2 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = kv_at(j + e * WARPS);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      o8[e].x = fmaf(pr[j + e * WARPS], v[e].x, o8[e].x);
      o8[e].y = fmaf(pr[j + e * WARPS], v[e].y, o8[e].y);
    }
  }
  for (; j < n_slots; j += WARPS) {
    const float2 v = kv_at(j);
    o8[0].x = fmaf(pr[j], v.x, o8[0].x);
    o8[0].y = fmaf(pr[j], v.y, o8[0].y);
  }
  og[grp * DH + d2] = ((o8[0].x + o8[1].x) + (o8[2].x + o8[3].x)) +
                      ((o8[4].x + o8[5].x) + (o8[6].x + o8[7].x));
  og[grp * DH + d2 + 1] = ((o8[0].y + o8[1].y) + (o8[2].y + o8[3].y)) +
                          ((o8[4].y + o8[5].y) + (o8[6].y + o8[7].y));
  __syncthreads();
  if (tid < DH) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < WARPS; ++g) a += og[g * DH + tid];
    reinterpret_cast<__nv_bfloat16*>(p.scratch + sc.ao)[
        (size_t)row * inner + head * DH + tid] = __float2bfloat16(a);
  }
  __syncthreads();
}

// The row phases: one block a row, thread t holding columns t + j THREADS
// (j < C) of it in registers, every load of a row started before the first
// use. C is 8 up to d = 2048 (every preset); wider rows take C = 32, where
// the registers spill.
constexpr int COLS = 8, COLS_WIDE = 32;
constexpr int MAX_D = COLS_WIDE * THREADS;

__device__ __forceinline__ int my_cols(int d) {
  return (d - threadIdx.x + THREADS - 1) / THREADS;
}

template <int C, typename T>
__device__ __forceinline__ void load_cols(float (&v)[C], const T* row, int n) {
#pragma unroll
  for (int j = 0; j < C; ++j)
    v[j] = j < n ? load_cg(row + threadIdx.x + j * THREADS) : 0.f;
}

// Two-pass LayerNorm statistics of a row held as above: returns the mean and
// sets rstd = 1 / sqrt(var + eps).
template <int C>
__device__ __forceinline__ float row_stats_cols(const float (&v)[C], int n,
                                                int d, float eps, float* sh,
                                                float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (j < n) s += v[j];
  const float mean = block_sum(s, sh) / d;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (j < n) q += (v[j] - mean) * (v[j] - mean);
  rstd = 1.f / sqrtf(block_sum(q, sh) / d + eps);
  return mean;
}

// xn = bf16(LN(v) * g) for the next product, into row `row` of scratch.
template <int C>
__device__ __forceinline__ void norm_out_cols(const DecodeParams& p,
                                              const Scratch& sc, int row,
                                              const float (&v)[C],
                                              const float (&g)[C], int n,
                                              float* sh) {
  float rstd;
  const float mean = row_stats_cols(v, n, p.d, p.eps, sh, rstd);
  __nv_bfloat16* xn =
      reinterpret_cast<__nv_bfloat16*>(p.scratch + sc.xn) + (size_t)row * p.d;
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (j < n)
      xn[threadIdx.x + j * THREADS] =
          __float2bfloat16((v[j] - mean) * rstd * g[j]);
}

// x -> f32 state and the first layer's xn.
template <int C>
__device__ void row_start(const DecodeParams& p, const Scratch& sc, int row,
                          float* sh) {
  const int n = my_cols(p.d);
  float v[C], g[C];
  load_cols(v, p.x + (size_t)row * p.d, n);
  load_cols(g, p.norms, n);
  float* xrow = p.scratch + sc.xst + (size_t)row * p.d;
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (j < n) xrow[threadIdx.x + j * THREADS] = v[j];
  norm_out_cols(p, sc, row, v, g, n, sh);
}

// After an out projection: x += LN(sum_chunks(part_o) * so) * g_out, then
// the next projection's input xn = bf16(LN(x) * g_next).
template <int C>
__device__ void attn_row_finish(const DecodeParams& p, const Scratch& sc,
                                int row, const float* __restrict__ so,
                                const float* __restrict__ g_out,
                                const float* __restrict__ g_next, float* buf,
                                float* sh) {
  const int d = p.d, nko = cdiv(p.heads * DH, p.kc[P_OS]), n = my_cols(d);
  float* xrow = p.scratch + sc.xst + (size_t)row * d;
  float sv[C], xv[C], go[C], gn[C], v[C];
  load_cols(sv, so, n);
  load_cols(xv, xrow, n);
  load_cols(go, g_out, n);
  load_cols(gn, g_next, n);
  sum_chunks_row(buf, p.scratch + sc.part_o + (size_t)row * d, nko,
                 (size_t)p.rows * d, d);  // the thread's own columns
#pragma unroll
  for (int j = 0; j < C; ++j)
    v[j] = j < n ? buf[threadIdx.x + j * THREADS] * sv[j] : 0.f;
  float rstd;
  const float mean = row_stats_cols(v, n, d, p.eps, sh, rstd);
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (j < n) {
      v[j] = xv[j] + (v[j] - mean) * rstd * go[j];
      xrow[threadIdx.x + j * THREADS] = v[j];
    }
  norm_out_cols(p, sc, row, v, gn, n, sh);
}

// The end of the folded FFN for one row: x += inv * (sum_chunks(part2) * s2
// - mu * c2), (mu, inv) from fc1's tile sums of h and h^2, then xn for the
// next layer, or after the last one the bf16 store of x.
template <int C>
__device__ void ffn_row_end(const DecodeParams& p, const Scratch& sc, int l,
                            int row, float* buf, float* sh) {
  const int d = p.d, F = p.F, tiles = F / TN, n = my_cols(d);
  const bool last = l + 1 == p.L;
  float* scr = p.scratch;
  float* xrow = scr + sc.xst + (size_t)row * d;
  float s2[C], c2[C], xv[C], gn[C], v[C];
  load_cols(s2, p.s2 + (size_t)l * d, n);
  load_cols(c2, p.c2 + (size_t)l * d, n);
  load_cols(xv, xrow, n);
  load_cols(gn, p.norms + (size_t)(last ? l : l + 1) * 5 * d, n);
  // the tiles' sums all at once, added over the block in a fixed order
  float h1 = 0.f, h2 = 0.f;
  for (int t = threadIdx.x; t < tiles; t += THREADS) {
    h1 += __ldcg(scr + sc.hstat + ((size_t)t * p.rows + row) * 2);
    h2 += __ldcg(scr + sc.hstat + ((size_t)t * p.rows + row) * 2 + 1);
  }
  const float m1 = block_sum(h1, sh);
  const float m2 = block_sum(h2, sh);
  const float mu = m1 / F;
  const float var = fmaxf(m2 / F - mu * mu, 0.f);
  const float inv = 1.f / sqrtf(var + p.eps);
  sum_chunks_row(buf, scr + sc.part2 + (size_t)row * d, cdiv(F, p.kc[P_FC2]),
                 (size_t)p.rows * d, d);
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (j < n) {
      const int c = threadIdx.x + j * THREADS;
      v[j] = xv[j] + inv * (buf[c] * s2[j] - mu * c2[j]);
      if (last)
        p.x_out[(size_t)row * d + c] = __float2bfloat16(v[j]);
      else
        xrow[c] = v[j];
    } else {
      v[j] = 0.f;
    }
  if (!last) norm_out_cols(p, sc, row, v, gn, n, sh);
}

__global__ void __launch_bounds__(THREADS, 1)
decode_step_kernel(const DecodeParams p,
                   const __grid_constant__ CUtensorMap m_qs,
                   const __grid_constant__ CUtensorMap m_os,
                   const __grid_constant__ CUtensorMap m_qc,
                   const __grid_constant__ CUtensorMap m_oc,
                   const __grid_constant__ CUtensorMap m_1,
                   const __grid_constant__ CUtensorMap m_2) {
  // the position first: a launch given one outside [0, S) counts it and
  // leaves before it asks for a weight box or writes anything
  const long long pos = *p.pos;
  if (pos < 0 || pos >= p.S) {
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(p.error, 1);
    return;
  }
  cg::grid_group grid = cg::this_grid();
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[WORKERS][RING];
  __shared__ int flag[WORKERS];
  const CUtensorMap* const maps[NPROD] = {&m_qs, &m_os, &m_qc,
                                          &m_oc, &m_1,  &m_2};
  const int d = p.d, inner = p.heads * DH, rows = p.rows;
  const Scratch sc = scratch_layout(rows, d, inner, p.F, p.kc[P_QS],
                                    p.kc[P_OS], p.kc[P_FC1], p.kc[P_FC2]);
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem) + mma8::RING_ALIGN - 1) /
      mma8::RING_ALIGN * mma8::RING_ALIGN);
  Worker w;
  w.half = threadIdx.x / WT;
  w.tid = threadIdx.x % WT;
  w.nworkers = WORKERS * gridDim.x;
  w.id = w.half * gridDim.x + blockIdx.x;  // the first items on every block
  w.ring = base + w.half * RING_BYTES;
  w.bars = bars[w.half];
  w.own = base + WORKERS * RING_BYTES + w.half * worker_bytes(p.kc[P_QS]);
  w.seq = 0;
  // the block-wide phases' region, over both workers' own regions
  float* xs = reinterpret_cast<float*>(base + WORKERS * RING_BYTES);
  float* sh = xs + d;  // block reductions of the row passes
  float* scr = p.scratch;
  const int block = blockIdx.x, nblocks = gridDim.x;
  const bool wide = d > COLS * THREADS;  // the row phases' columns a thread
  int phase = 0;

  if (w.tid == 0) {
    for (int i = 0; i < RING; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       mma8::shared_address(&w.bars[i]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < NPROD; ++i)
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(maps[i]))
                   : "memory");
  }
  __syncthreads();
  prefetch(p, sc, maps, w, P_QS, 0);
  prefetch_kv(p, w, 0);

  // arrival counters to zero; x -> f32 state, and the first layer's xn
  if (block == 0) {
    int* cnt = reinterpret_cast<int*>(scr + sc.cnt);
    for (int i = threadIdx.x; i < rows / MR * (p.F / TN); i += THREADS)
      cnt[i] = 0;
  }
  for (int row = block; row < rows; row += nblocks) {
    if (wide)
      row_start<COLS_WIDE>(p, sc, row, sh);
    else
      row_start<COLS>(p, sc, row, sh);
    __syncthreads();
  }
  const int phases = 1 + PHASES * p.L;
  grid_barrier(grid, p, phases, phase);

  for (int l = 0; l < p.L; ++l) {
    const float* norms = p.norms + (size_t)l * 5 * d;
    for (int branch = 0; branch < 2; ++branch) {  // self, then cross
      const bool self = branch == 0;
      const float* so = (self ? p.so_s : p.so_c) + (size_t)l * d;

      proj_phase(p, sc, maps, w, self ? P_QS : P_QC, l, flag);
      if (self) kv_phase(p, sc, w, l);
      grid_barrier(grid, p, phases, phase);

      for (int it = block; it < rows * p.heads; it += nblocks) {
        if (self)
          attend_item<true>(p, sc, l, it / p.heads, it % p.heads, xs, pos);
        else
          attend_item<false>(p, sc, l, it / p.heads, it % p.heads, xs, pos);
      }
      grid_barrier(grid, p, phases, phase);

      proj_phase(p, sc, maps, w, self ? P_OS : P_OC, l, flag);
      grid_barrier(grid, p, phases, phase);

      const float* g_out = norms + (self ? 1 : 3) * d;
      const float* g_next = norms + (self ? 2 : 4) * d;
      for (int row = block; row < rows; row += nblocks) {
        if (wide)
          attn_row_finish<COLS_WIDE>(p, sc, row, so, g_out, g_next, xs, sh);
        else
          attn_row_finish<COLS>(p, sc, row, so, g_out, g_next, xs, sh);
        __syncthreads();
      }
      grid_barrier(grid, p, phases, phase);
    }

    proj_phase(p, sc, maps, w, P_FC1, l, flag);
    grid_barrier(grid, p, phases, phase);

    proj_phase(p, sc, maps, w, P_FC2, l, flag);
    grid_barrier(grid, p, phases, phase);

    const bool last = l + 1 == p.L;
    for (int row = block; row < rows; row += nblocks) {
      if (wide)
        ffn_row_end<COLS_WIDE>(p, sc, l, row, xs, sh);
      else
        ffn_row_end<COLS>(p, sc, l, row, xs, sh);
      __syncthreads();
    }
    grid_barrier(grid, p, phases, phase, !last);
  }
}

}  // namespace

// Floats of scratch one launch needs.
extern "C" long long favae_decode_step_scratch(int rows, int d, int heads,
                                               int F, int kc_q, int kc_o,
                                               int kc_1, int kc_2) {
  return (long long)scratch_layout(rows, d, heads * DH, F, kc_q, kc_o, kc_1,
                                   kc_2).total;
}

// Bytes of dynamic shared memory a block takes at these shapes.
extern "C" long long favae_decode_step_smem(int d, int S, int M, int kc_q) {
  return (long long)smem_bytes(d, S, M, kc_q);
}

// Blocks of the cooperative grid for these shapes: one an SM (the kernel is
// built for one: __launch_bounds__(THREADS, 1)) if the occupancy query lets
// a block be resident, else 0; a negative CUDA error on failure.
extern "C" int favae_decode_step_grid(int d, int S, int M, int kc_q) {
  const size_t smem = smem_bytes(d, S, M, kc_q);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (smem > SMEM_ALLOWED) return 0;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_step_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_ALLOWED);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, decode_step_kernel, THREADS, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return occ >= 1 ? sms : 0;
}

// Phases of a layer, each followed by a grid barrier (but the last layer's
// last): the phase clock holds 2 (1 + phases L) times.
extern "C" int favae_decode_step_phases() { return PHASES; }

// The work items of a (K, N) product cut into chunks of kc rows, in the
// kernel's order, five ints each (tile, chunk, row group, k0, k1) into `out`
// when it holds `cap` of them; returns how many there are.
extern "C" int favae_decode_step_items(int K, int N, int kc, int rows,
                                       int* out, int cap) {
  const int n = items_of(K, N, kc, rows);
  for (int it = 0; it < n && it < cap; ++it) {
    const Item t = item_of(K, N, kc, it);
    const int v[5] = {t.tile, t.chunk, t.group, t.k0, t.k1};
    for (int i = 0; i < 5; ++i) out[5 * it + i] = v[i];
  }
  return n;
}

// One decode step. Pointers as in DecodeParams plus the six int8 stacks
// (L, K, N) (`clock` may be null; `pos` and `error` are device scalars);
// `grid` from favae_decode_step_grid for the same shapes. Returns the CUDA
// error of the cooperative launch (0 on success; cudaErrorNotSupported where
// CUDA gives no tensor map).
extern "C" int favae_decode_step(
    const void* x, void* caches, const void* cross_kv, const void* cross_bias,
    const void* rel_rows, const void* wq_s, const void* sq_s, const void* wo_s,
    const void* so_s, const void* wq_c, const void* sq_c, const void* wo_c,
    const void* so_c, const void* wkv, const void* null_kv, const void* norms,
    const void* w1, const void* s1, const void* w2, const void* s2,
    const void* c2, void* x_out, void* scratch, void* clock, const void* pos,
    void* error, int L, int rows, int d, int heads, int S, int M, int F,
    int kc_q, int kc_o, int kc_1, int kc_2, float eps, int grid,
    void* stream) {
  DecodeParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.caches = static_cast<__nv_bfloat16*>(caches);
  p.cross_kv = static_cast<const __nv_bfloat16*>(cross_kv);
  p.cross_bias = static_cast<const float*>(cross_bias);
  p.rel_rows = static_cast<const float*>(rel_rows);
  p.sq_s = static_cast<const float*>(sq_s);
  p.so_s = static_cast<const float*>(so_s);
  p.sq_c = static_cast<const float*>(sq_c);
  p.so_c = static_cast<const float*>(so_c);
  p.wkv = static_cast<const __nv_bfloat16*>(wkv);
  p.null_kv = static_cast<const float*>(null_kv);
  p.norms = static_cast<const float*>(norms);
  p.s1 = static_cast<const float*>(s1);
  p.s2 = static_cast<const float*>(s2);
  p.c2 = static_cast<const float*>(c2);
  p.x_out = static_cast<__nv_bfloat16*>(x_out);
  p.scratch = static_cast<float*>(scratch);
  p.clock = static_cast<unsigned long long*>(clock);
  p.pos = static_cast<const long long*>(pos);
  p.error = static_cast<int*>(error);
  p.L = L; p.rows = rows; p.d = d; p.heads = heads; p.S = S; p.M = M;
  p.F = F;
  const int kcs[NPROD] = {kc_q, kc_o, kc_q, kc_o, kc_1, kc_2};
  for (int i = 0; i < NPROD; ++i) p.kc[i] = kcs[i];
  p.eps = eps;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (d % TN || d > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  const int inner = heads * DH;
  const void* ws[NPROD] = {wq_s, wo_s, wq_c, wo_c, w1, w2};
  const int ks[NPROD] = {d, inner, d, inner, d, F};
  const int ns[NPROD] = {inner, d, inner, d, F, d};
  CUtensorMap maps[NPROD];
  for (int i = 0; i < NPROD; ++i) {
    const cuuint64_t dims[3] = {(cuuint64_t)ns[i], (cuuint64_t)ks[i],
                                (cuuint64_t)L};
    if (!mma8::weight_map(&maps[i], ws[i], 3, dims))
      return static_cast<int>(cudaErrorNotSupported);
  }
  void* args[] = {&p, &maps[0], &maps[1], &maps[2], &maps[3], &maps[4],
                  &maps[5]};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(decode_step_kernel), dim3(grid), dim3(THREADS),
      args, smem_bytes(d, S, M, kc_q), static_cast<cudaStream_t>(stream)));
}
