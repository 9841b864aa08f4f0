// Fused int8 feed-forward block of CAT decode, in one launch:
//   y = x + inv * (gelu_tanh(LN_in(x) W1q s1) W2'q s2 - mu * c)
// with int8 W1 (K, F) and gamma-folded int8 W2' (F, K), the mid LayerNorm
// folded into inv * (h W2' - mu * c), c = colsum(dequantised W2'), (mu, inv)
// h's row statistics taken in f32 before h is rounded to bf16.
//
// Replaces favae_tpu/ops/ffn_int8.py::ffn_block_int8 (body _ffn_kernel),
// which walks a sequential grid over F tiles with its sums in scratch. Bound:
// the 2 K F bytes of int8 weights (13.1 MB at K 1280: 3.9 us at 3.35 TB/s).
// One cooperative launch (every block resident, so the waits below end) of
// one block an SM, two workers of 128 threads a block. The products are cut
// into items of a 128-column tile and a chunk of K (fc1) or of F (fc2, whole
// fc1 tiles); fc1's items go to the workers from the first up, fc2's from
// the last down. What holds such a kernel back on an H100 is the chain of
// dependent trips to L2 (about a microsecond each while weights stream) and
// an SM's rate of ordinary loads (a few tens of GB/s), not the bytes:
//   * The whole layer's weights are held in the grid's shared memory, each
//     64 x 128 box in its own slot with its own mbarrier, asked for by TMA:
//     a worker's fc1 boxes at its start, its fc2 boxes once its fc1
//     products are done (while fc1's weights and x stream, nothing else is
//     in flight; fc2's land long before h exists).
//   * Products on the tensor cores: int8_mma.cuh's stage (mma.sync m16n8k16
//     on the transposed problem, the rows the n = 8 side, one or two groups
//     of 8 rows a pass, int8 -> bf16 exact). More rows loop over passes of
//     16 rows on the boxes already in shared memory.
//   * LN_in without a launch: each block takes the statistics of every row
//     at its start (two-pass variance, a row's loads in flight at once) and
//     writes the first pass's xn, rounded to bf16, straight into its workers'
//     activations.
//   * Four phases, each waiting only on the one before (integer counters,
//     release and acquire; a worker's thread 0 polls): fc1 products; fc1
//     finish, the tile's rows dealt over its chunks' items (each adds the
//     tile's chunks in ascending order for its rows, applies s1 and GELU,
//     stores h in bf16 and the row's f32 sums of h and h^2 over the tile);
//     fc2 products, an item waiting on its own fc1 tiles only; fc2 finish,
//     the K tile's rows dealt over its chunks' items (chunks added in
//     ascending order, (mu, inv) from the tile sums in ascending order,
//     bf16(x + inv * (acc * s2 - mu * c))). Dealing the finishes over the
//     items keeps every load of one in a single trip.
// No float atomics: the same inputs give the same bits. The integer counters
// are one set a stream (the wrapper keeps them), zero between launches: the
// last block to finish sets them back, so every launch and every CUDA-graph
// replay starts clean. A wait that never ends traps.
#include "int8_mma.cuh"

namespace {

using namespace favae;

constexpr int WT = mma8::THREADS;      // threads of a worker: 128
constexpr int WORKERS = 2;             // workers of a block, one block an SM
constexpr int BLOCK = WORKERS * WT;
constexpr int SK = mma8::SK;           // rows of K in a box
constexpr int BOX = mma8::STAGE_BYTES;  // 64 x 128 int8
constexpr int PASS = 16;               // rows of a pass: two groups of 8
constexpr int MAX_SLOTS = 32;          // boxes a worker holds
constexpr int LN_J = 6;                // 16-byte pieces of a row a lane holds
constexpr int MAX_K = LN_J * 32 * 8;   // the widest row LN_in holds: 1536
constexpr int LN_CJ = 2;               // and of its chunk of K
constexpr int MAX_KC1 = LN_CJ * 32 * 8;  // the longest chunk of K: 512
// dynamic shared memory the kernel is allowed, set once whatever the shapes
constexpr size_t SMEM_ALLOWED = 224 * 1024;
constexpr int SPIN_LIMIT = 1 << 26;
constexpr int MAX_TILES1 = 4 * MAX_K / TN;  // fc1 column tiles: 48
// chunks of K (fc1) and of F (fc2) whose loads a finish has in flight at once
constexpr int MAX_CH1 = 8;
constexpr int MAX_CH2 = 32;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline int smaller(int a, int b) { return a < b ? a : b; }

// How a call is cut: fc1 (K, F) in chunks of kc1 rows of K, fc2 (F, K) in
// chunks of kc2 rows of F (whole fc1 tiles), over `workers` workers.
struct Plan {
  int rows, K, F, kc1, kc2, workers;
  __host__ __device__ int tiles(int P) const { return (P == 0 ? F : K) / TN; }
  __host__ __device__ int depth(int P) const { return P == 0 ? K : F; }
  __host__ __device__ int kc(int P) const { return P == 0 ? kc1 : kc2; }
  __host__ __device__ int chunks(int P) const { return cdiv(depth(P), kc(P)); }
  __host__ __device__ int items(int P) const { return tiles(P) * chunks(P); }
  // the first item of product P that worker w takes; it then takes every
  // workers-th: fc1 from worker 0 up, fc2 from the last worker down
  __host__ __device__ int first(int P, int w) const {
    return P == 0 ? w : workers - 1 - w;
  }
};

struct Item {
  int tile, chunk, k0, k1, stages;
};

// Item `it` of product P: column tile fastest, then chunk.
__host__ __device__ inline Item item_of(const Plan& p, int P, int it) {
  Item t;
  t.tile = it % p.tiles(P);
  t.chunk = it / p.tiles(P);
  t.k0 = t.chunk * p.kc(P);
  t.k1 = smaller(p.depth(P), t.k0 + p.kc(P));
  t.stages = cdiv(t.k1 - t.k0, SK);
  return t;
}

// Boxes worker w holds: all of its items' boxes.
__host__ __device__ inline int boxes_of(const Plan& p, int w) {
  int n = 0;
  for (int P = 0; P < 2; ++P)
    for (int it = p.first(P, w); it < p.items(P); it += p.workers)
      n += item_of(p, P, it).stages;
  return n;
}

__host__ inline int slots_of(const Plan& p) {
  int most = 0;
  for (int w = 0; w < p.workers; ++w) {
    const int n = boxes_of(p, w);
    most = n > most ? n : most;
  }
  return most;
}

// Offsets of the scratch segments, in floats (16-byte aligned): partial
// products of the chunks, h (bf16: half a float an element), h's tile sums.
struct Scratch {
  size_t part1, part2, h, hstat, total;
};

__host__ __device__ inline Scratch scratch_layout(const Plan& p) {
  Scratch s;
  size_t o = 0;
  s.part1 = o;  o += pad4((size_t)p.chunks(0) * p.rows * p.F);
  s.part2 = o;  o += pad4((size_t)p.chunks(1) * p.rows * p.K);
  s.h = o;      o += pad4((size_t)p.rows * p.F / 2);
  s.hstat = o;  o += pad4((size_t)p.tiles(0) * p.rows * 2);  // sum h, h^2
  s.total = o;
  return s;
}

// The stream's integer counters: a column tile's fc1 products in and fc1
// rows finished, a column tile's fc2 products in, blocks done.
struct Counters {
  int cnt1, fin1, cnt2, done, total;
};

__host__ __device__ inline Counters counter_layout(int K, int F) {
  Counters c;
  c.cnt1 = 0;
  c.fin1 = F / TN;
  c.cnt2 = 2 * (F / TN);
  c.done = c.cnt2 + K / TN;
  c.total = c.done + 1;
  return c;
}

// A worker's own shared memory beside its boxes: the bf16 activations of a
// pass (16 rows of the longest chunk), then the finishes' sums (a row's
// 2 x 48 tile sums at most).
__host__ __device__ inline int xs_bytes(const Plan& p) {
  const int kc = p.kc1 > p.kc2 ? p.kc1 : p.kc2;
  return PASS * mma8::x_stride(cdiv(kc, SK) * SK) * 2;
}

__host__ __device__ inline int own_bytes(const Plan& p) {
  return (xs_bytes(p) + 2 * MAX_TILES1 * 4 + 127) / 128 * 128;
}

// Dynamic shared memory of a block: room to align the boxes, each worker's
// slots and own region, the block's LN_in statistics of every row.
__host__ __device__ inline size_t smem_bytes(const Plan& p, int slots) {
  return mma8::RING_ALIGN + (size_t)WORKERS * slots * BOX +
         (size_t)WORKERS * own_bytes(p) +
         ((size_t)p.rows * 8 + 127) / 128 * 128;
}

struct FfnParams {
  const __nv_bfloat16* x;  // (rows, K)
  const float* g_in;       // (K,)
  const float* s1;         // (F,)
  const float* s2;         // (K,)
  const float* c2;         // (K,)
  __nv_bfloat16* y;        // (rows, K)
  float* scratch;
  int* counters;
  Plan p;
  int slots;
  float eps;
};

// What one worker works with.
struct Worker {
  int half, tid, warp, lane;
  uint8_t* boxes;  // slots of BOX bytes at a RING_ALIGN boundary
  uint64_t* bars;  // one mbarrier a slot, used once a launch
  __nv_bfloat16* xs;
  float* red;

  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + half), "r"(WT) : "memory");
  }
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v)
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

// bf16 e of the 8 packed in `u`, as f32 (a bf16 is the high half of its f32).
__device__ __forceinline__ float bf16_at(const uint4& u, int e) {
  const uint32_t word = e < 2 ? u.x : e < 4 ? u.y : e < 6 ? u.z : u.w;
  return __uint_as_float(e % 2 ? word & 0xffff0000u : word << 16);
}

// Where LN_in's output of the first pass goes for a worker's first fc1
// item: xs at row stride ldx, columns [k0, k1) of K (k0 == k1: no item).
struct Fill {
  __nv_bfloat16* xs;
  int ldx, k0, k1;
};

// LN_in at the block's start, by all its threads: warp v of 8 takes rows v,
// v + 8, ..., a lane the 16-byte pieces lane + 32 j (j < J) of a row, all
// of them and the g of both workers' chunks in flight before the first sum;
// two-pass variance, stats[r] = (mean, 1 / sqrt(var + eps)). The rows of
// the first pass also go, normalised and rounded to bf16, straight into
// each worker's activations for its first fc1 item (a piece of the chunk
// is held by one lane).
template <int J>
__device__ void ln_start(const FfnParams& a, float2* stats,
                         const Fill (&fill)[WORKERS]) {
  const int K = a.p.K, pieces = K / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4 g[WORKERS][J][2];
#pragma unroll
  for (int h = 0; h < WORKERS; ++h)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = 8 * (lane + 32 * j);
      const bool in = k >= fill[h].k0 && k < fill[h].k1;
      const float4* gp = reinterpret_cast<const float4*>(a.g_in + k);
      g[h][j][0] = in ? __ldg(gp) : make_float4(0.f, 0.f, 0.f, 0.f);
      g[h][j][1] = in ? __ldg(gp + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  for (int r = warp; r < a.p.rows; r += BLOCK / 32) {
    const uint4* row = reinterpret_cast<const uint4*>(a.x + (size_t)r * K);
    uint4 v[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      v[j] = lane + 32 * j < pieces ? __ldg(row + lane + 32 * j)
                                    : make_uint4(0, 0, 0, 0);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) s += bf16_at(v[j], e);  // zeros past K
    const float mean = warp_sum(s) / K;
    float q2 = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (lane + 32 * j < pieces)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = bf16_at(v[j], e) - mean;
          q2 += d * d;
        }
    const float rstd = 1.f / sqrtf(warp_sum(q2) / K + a.eps);
    if (lane == 0) stats[r] = make_float2(mean, rstd);
    if (r >= PASS) continue;
#pragma unroll
    for (int h = 0; h < WORKERS; ++h)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = 8 * (lane + 32 * j);
        if (k < fill[h].k0 || k >= fill[h].k1) continue;
        const float gg[8] = {g[h][j][0].x, g[h][j][0].y, g[h][j][0].z,
                             g[h][j][0].w, g[h][j][1].x, g[h][j][1].y,
                             g[h][j][1].z, g[h][j][1].w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(
              (bf16_at(v[j], 2 * e) - mean) * rstd * gg[2 * e],
              (bf16_at(v[j], 2 * e + 1) - mean) * rstd * gg[2 * e + 1]);
          o[e] = *reinterpret_cast<const uint32_t*>(&b);
        }
        *reinterpret_cast<uint4*>(fill[h].xs + r * fill[h].ldx +
                                  (k - fill[h].k0)) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
  }
  // the first pass's rows past the last are zeros
  for (int h = 0; h < WORKERS; ++h)
    for (int i = threadIdx.x; i < (PASS - a.p.rows) * fill[h].ldx; i += BLOCK)
      fill[h].xs[a.p.rows * fill[h].ldx + i] = __float2bfloat16(0.f);
}

// LN_in of rows r0 .. r0 + rv - 1 into the pass's activations: xs[m][k - k0]
// = bf16((x - mean) * rstd * g) for k in [k0, k1), zeros for rows past rv.
// Warp v takes rows 4 v .. 4 v + 3 of the pass, a lane the chunk's 16-byte
// pieces lane + 32 jj (jj < LN_CJ); every load in flight at once.
__device__ void ln_fill(const FfnParams& a, const Worker& w,
                        const float2* stats, int ldx, int r0, int rv, int k0,
                        int k1) {
  const int K = a.p.K, chunk = (k1 - k0) / 8;
  float4 g[LN_CJ][2];
  uint4 c[4][LN_CJ];
#pragma unroll
  for (int jj = 0; jj < LN_CJ; ++jj) {
    const int q = w.lane + 32 * jj;
    const float4* gp = reinterpret_cast<const float4*>(a.g_in + k0 + 8 * q);
    g[jj][0] = q < chunk ? __ldg(gp) : make_float4(0.f, 0.f, 0.f, 0.f);
    g[jj][1] = q < chunk ? __ldg(gp + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4* row = reinterpret_cast<const uint4*>(
          a.x + (size_t)(r0 + smaller(w.warp * 4 + i, rv - 1)) * K + k0);
      c[i][jj] = q < chunk ? __ldg(row + q) : make_uint4(0, 0, 0, 0);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = w.warp * 4 + i;
    const float2 st = stats[r0 + smaller(m, rv - 1)];
#pragma unroll
    for (int jj = 0; jj < LN_CJ; ++jj) {
      const int q = w.lane + 32 * jj;
      if (q >= chunk) continue;
      const float gg[8] = {g[jj][0].x, g[jj][0].y, g[jj][0].z, g[jj][0].w,
                           g[jj][1].x, g[jj][1].y, g[jj][1].z, g[jj][1].w};
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(
            (bf16_at(c[i][jj], 2 * e) - st.x) * st.y * gg[2 * e],
            (bf16_at(c[i][jj], 2 * e + 1) - st.x) * st.y * gg[2 * e + 1]);
        o[e] = m < rv ? *reinterpret_cast<const uint32_t*>(&b) : 0u;
      }
      *reinterpret_cast<uint4*>(w.xs + m * ldx + 8 * q) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// The item's products of one pass: rows r0 .. r0 + 8 NB - 1 of xs times all
// of its boxes, the (rows, 128) f32 partial stored to part (its own (rows,
// 128) block of the scratch) for the rows below `rows`.
template <int NB>
__device__ __forceinline__ void pass_products(const Worker& w, const Item& t,
                                              int slot, int ldx, float* part,
                                              int rows, int r0) {
  float acc[2][NB][2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][b][h][i] = 0.f;
  for (int s = 0; s < t.stages; ++s) {
    mma8::wait_barrier(&w.bars[slot + s], 0);  // the box has landed
    mma8::stage_products<NB>(w.boxes + (size_t)(slot + s) * BOX, w.xs, ldx,
                             s * SK, w.warp, w.lane, acc);
  }
  // acc[.][b][h] = {(col 4g+2h, row 2t), (4g+2h, 2t+1), (4g+2h+1, 2t),
  // (4g+2h+1, 2t+1)} of row group b
  const int g = w.lane >> 2, tq = w.lane & 3;
  const int col = w.warp * 32 + g * 4;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + b * 8 + 2 * tq + r;
      if (row < rows)
        *reinterpret_cast<float4*>(part + (size_t)row * TN + col) =
            make_float4(acc[0][b][0][r] + acc[1][b][0][r],
                        acc[0][b][0][2 + r] + acc[1][b][0][2 + r],
                        acc[0][b][1][r] + acc[1][b][1][r],
                        acc[0][b][1][2 + r] + acc[1][b][1][2 + r]);
    }
}

// The (rows, 128) partial of item (tile, chunk) of a product with `nch`
// chunks: part[tile][chunk][row][128], so that a tile's chunks lie together.
__device__ __forceinline__ float* partial(float* part, const Item& t, int nch,
                                          int rows) {
  return part + ((size_t)t.tile * nch + t.chunk) * rows * TN;
}

// Arrival of an item at `cnt`: the barrier orders the worker's stores
// before its thread 0's release.
__device__ __forceinline__ void arrive(const Worker& w, int* cnt) {
  w.sync();
  if (w.tid == 0) red_release(cnt, 1);
}

// Thread 0 waits until `cnt` reaches n; its acquire and the barrier order
// the worker's later loads after the arrivals. A wait that never ends traps.
__device__ __forceinline__ void wait_for(const Worker& w, const int* cnt,
                                         int n) {
  if (w.tid == 0)
    for (int spins = 0; load_acquire(cnt) < n; ++spins)
      if (spins > SPIN_LIMIT) __trap();
  w.sync();
}

// Phase 1, an fc1 item: LN_in of each pass's rows for its chunk of K (but
// for the first pass of the worker's first item, filled at the start) and
// its products, then its arrival at the tile's counter.
__device__ void fc1_products(const FfnParams& a, const Scratch& sc,
                             const Counters& cn, const Worker& w,
                             const float2* stats, const Item& t, int slot,
                             bool first) {
  const Plan& p = a.p;
  const int rows = p.rows;
  const int ldx = mma8::x_stride(t.stages * SK);
  float* part = partial(a.scratch + sc.part1, t, p.chunks(0), rows);
  for (int r0 = 0; r0 < rows; r0 += PASS) {
    const int rv = smaller(PASS, rows - r0);
    if (!first || r0 > 0) {
      ln_fill(a, w, stats, ldx, r0, rv, t.k0, t.k1);
      w.sync();  // the pass's activations are whole
    }
    if (rv > 8)
      pass_products<2>(w, t, slot, ldx, part, rows, r0);
    else
      pass_products<1>(w, t, slot, ldx, part, rows, r0);
    w.sync();  // xs is free
  }
  arrive(w, a.counters + cn.cnt1 + t.tile);
}

// Phase 2, the same fc1 item once its tile's chunks are all in: the tile's
// rows chunk, chunk + chunks, ... each by the 128 threads a column: the
// chunks added in ascending order, h = gelu(sum * s1) stored in bf16, the
// row's f32 sums of h and h^2 over the tile (before the rounding) to hstat;
// then its arrival at the tile's finish counter.
__device__ void fc1_finish(const FfnParams& a, const Scratch& sc,
                           const Counters& cn, const Worker& w,
                           const Item& t) {
  const Plan& p = a.p;
  const int rows = p.rows, F = p.F, nch = p.chunks(0);
  if (t.chunk >= rows) return;  // no row of its own
  wait_for(w, a.counters + cn.cnt1 + t.tile, nch);
  const int col = t.tile * TN + w.tid;
  const float s1 = a.s1[col];
  const float* part = a.scratch + sc.part1 + (size_t)t.tile * nch * rows * TN;
  auto* h = reinterpret_cast<__nv_bfloat16*>(a.scratch + sc.h);
  for (int r = t.chunk; r < rows; r += nch * 2) {  // two rows a trip
    const int r2 = smaller(r + nch, rows - 1);
    float v[2][MAX_CH1];
#pragma unroll
    for (int c = 0; c < MAX_CH1; ++c) {
      const int cc = smaller(c, nch - 1);
      v[0][c] = __ldcg(part + ((size_t)cc * rows + r) * TN + w.tid);
      v[1][c] = __ldcg(part + ((size_t)cc * rows + r2) * TN + w.tid);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i ? r + nch : r;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_CH1; ++c)
        if (c < nch) acc += v[i][c];
      const float hv = gelu_tanh(acc * s1);
      if (row < rows) h[(size_t)row * F + col] = __float2bfloat16(hv);
      const float sum = warp_sum(hv), sq = warp_sum(hv * hv);
      if (w.lane == 0) {
        w.red[(w.warp * 2 + i) * 2] = sum;
        w.red[(w.warp * 2 + i) * 2 + 1] = sq;
      }
    }
    w.sync();
    if (w.tid < 4) {  // rows r and r + nch, sums of h and h^2
      const int i = w.tid / 2, k = w.tid % 2, row = i ? r + nch : r;
      float v4 = 0.f;
#pragma unroll
      for (int ww = 0; ww < 4; ++ww) v4 += w.red[(ww * 2 + i) * 2 + k];
      if (row < rows)
        a.scratch[sc.hstat + ((size_t)t.tile * rows + row) * 2 + k] = v4;
    }
    w.sync();  // red is free
  }
  arrive(w, a.counters + cn.fin1 + t.tile);
}

// Phase 3, an fc2 item: waits for the fc1 tiles of its chunk of F to be
// finished, multiplies their h by its boxes, then arrives at the counter of
// its column tile of K.
__device__ void fc2_products(const FfnParams& a, const Scratch& sc,
                             const Counters& cn, const Worker& w,
                             const Item& t, int slot) {
  const Plan& p = a.p;
  const int rows = p.rows, F = p.F;
  for (int tile = t.k0 / TN; tile < cdiv(t.k1, TN); ++tile)  // h's tiles
    wait_for(w, a.counters + cn.fin1 + tile, smaller(p.chunks(0), rows));
  const int kc_pad = t.stages * SK;
  const int ldx = mma8::x_stride(kc_pad);
  const auto* h = reinterpret_cast<const __nv_bfloat16*>(a.scratch + sc.h);
  float* part = partial(a.scratch + sc.part2, t, p.chunks(1), rows);
  for (int r0 = 0; r0 < rows; r0 += PASS) {
    const int rv = smaller(PASS, rows - r0);
    if (rv > 8) {
      mma8::fill_x<2>(w.xs, ldx, h, F, r0, rv, t.k0, t.k1, kc_pad, w.tid, WT);
      mma8::wait_copies<0>();
      w.sync();
      pass_products<2>(w, t, slot, ldx, part, rows, r0);
    } else {
      mma8::fill_x<1>(w.xs, ldx, h, F, r0, rv, t.k0, t.k1, kc_pad, w.tid, WT);
      mma8::wait_copies<0>();
      w.sync();
      pass_products<1>(w, t, slot, ldx, part, rows, r0);
    }
    w.sync();  // xs is free
  }
  arrive(w, a.counters + cn.cnt2 + t.tile);
}

// Phase 4, the same fc2 item once its tile's chunks are all in: rows chunk,
// chunk + chunks, ... of its column tile of K, a column a thread: the chunks
// added in ascending order, (mu, inv) from the row's fc1 tile sums added in
// ascending order, y = bf16(x + inv * (acc * s2 - mu * c)).
__device__ void fc2_finish(const FfnParams& a, const Scratch& sc,
                           const Counters& cn, const Worker& w,
                           const Item& t) {
  const Plan& p = a.p;
  const int rows = p.rows, K = p.K, F = p.F, nch = p.chunks(1);
  const int tiles1 = p.tiles(0);
  if (t.chunk >= rows) return;  // no row of its own
  wait_for(w, a.counters + cn.cnt2 + t.tile, nch);
  const int col = t.tile * TN + w.tid;
  const float s2 = a.s2[col], c2 = a.c2[col];
  const float* part = a.scratch + sc.part2 + (size_t)t.tile * nch * rows * TN;
  for (int r = t.chunk; r < rows; r += nch) {
    // every load in flight before the first add: the row's chunks, x, and
    // its 2 x tiles1 tile sums spread over the threads, gathered in red
    float v[MAX_CH2];
#pragma unroll
    for (int c = 0; c < MAX_CH2; ++c)
      v[c] = __ldcg(part + ((size_t)smaller(c, nch - 1) * rows + r) * TN +
                    w.tid);
    const float xv = __bfloat162float(a.x[(size_t)r * K + col]);
    float hv = 0.f;
    if (w.tid < 2 * tiles1)
      hv = __ldcg(a.scratch + sc.hstat +
                  ((size_t)(w.tid % tiles1) * rows + r) * 2 + w.tid / tiles1);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_CH2; ++c)
      if (c < nch) acc += v[c];
    if (w.tid < 2 * tiles1) w.red[w.tid] = hv;  // [sum][tile]
    w.sync();
    float m[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // the same order in every thread
      m[k] = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_TILES1; ++i)
        if (i < tiles1) m[k] += w.red[k * tiles1 + i];
    }
    const float mu = m[0] / F;
    const float var = fmaxf(m[1] / F - mu * mu, 0.f);
    const float inv = 1.f / sqrtf(var + a.eps);
    a.y[(size_t)r * K + col] =
        __float2bfloat16(xv + inv * (acc * s2 - mu * c2));
    w.sync();  // red is free
  }
}

// Every box of the worker's items of product P, asked for by its thread 0
// into its slots from `slot` on; returns the slot after them.
__device__ int issue_boxes(const Plan& p, const Worker& w, int id, int P,
                           const CUtensorMap* map, int slot) {
  for (int it = p.first(P, id); it < p.items(P); it += p.workers) {
    const Item t = item_of(p, P, it);
    for (int st = 0; st < t.stages; ++st, ++slot)
      mma8::issue_box3(w.boxes + (size_t)slot * BOX, &w.bars[slot], map,
                       t.tile * TN, t.k0 + st * SK, 0);
  }
  return slot;
}

__global__ void __launch_bounds__(BLOCK, 1)
ffn_int8_kernel(const FfnParams a, const __grid_constant__ CUtensorMap m1,
                const __grid_constant__ CUtensorMap m2) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[WORKERS][MAX_SLOTS];
  __shared__ int last_block;
  const Plan& p = a.p;
  const Scratch sc = scratch_layout(p);
  const Counters cn = counter_layout(p.K, p.F);
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem) + mma8::RING_ALIGN - 1) /
      mma8::RING_ALIGN * mma8::RING_ALIGN);
  Worker w;
  w.half = threadIdx.x / WT;
  w.tid = threadIdx.x % WT;
  w.warp = w.tid >> 5;
  w.lane = w.tid & 31;
  w.boxes = base + (size_t)w.half * a.slots * BOX;
  w.bars = bars[w.half];
  uint8_t* own = base + (size_t)WORKERS * a.slots * BOX +
                 (size_t)w.half * own_bytes(p);
  w.xs = reinterpret_cast<__nv_bfloat16*>(own);
  w.red = reinterpret_cast<float*>(own + xs_bytes(p));
  // worker id: the first items on every block
  const int id = w.half * gridDim.x + blockIdx.x;

  // every box of the worker's fc1 items asked for at once
  if (w.tid == 0) {
    const int n = boxes_of(p, id);
    for (int i = 0; i < n; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       mma8::shared_address(&w.bars[i]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&m1))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&m2))
                 : "memory");
    issue_boxes(p, w, id, 0, &m1, 0);
  }
  float2* stats = reinterpret_cast<float2*>(
      base + (size_t)WORKERS * (a.slots * BOX + own_bytes(p)));
  Fill fill[WORKERS];
  for (int h = 0; h < WORKERS; ++h) {
    const int it = p.first(0, h * gridDim.x + blockIdx.x);
    const Item t = item_of(p, 0, it < p.items(0) ? it : 0);
    fill[h].xs = reinterpret_cast<__nv_bfloat16*>(
        base + (size_t)WORKERS * a.slots * BOX + (size_t)h * own_bytes(p));
    fill[h].ldx = mma8::x_stride(t.stages * SK);
    fill[h].k0 = t.k0;
    fill[h].k1 = it < p.items(0) ? t.k1 : t.k0;
  }
  if (p.K <= 5 * 32 * 8)  // 16-byte pieces of a row a lane holds
    ln_start<5>(a, stats, fill);
  else
    ln_start<LN_J>(a, stats, fill);
  __syncthreads();  // the mbarriers are initialised, LN_in's start is done

  // the four phases; a worker waits only on the phase before, which never
  // waits, so the grid (all resident) always goes on. fc2's boxes are asked
  // for once the worker's fc1 products are done: while fc1's weights and x
  // stream, nothing else is in flight.
  int slot = 0;
  for (int it = p.first(0, id); it < p.items(0); it += p.workers) {
    const Item t = item_of(p, 0, it);
    fc1_products(a, sc, cn, w, stats, t, slot, it == p.first(0, id));
    slot += t.stages;
  }
  if (w.tid == 0) issue_boxes(p, w, id, 1, &m2, slot);
  for (int it = p.first(0, id); it < p.items(0); it += p.workers)
    fc1_finish(a, sc, cn, w, item_of(p, 0, it));
  for (int it = p.first(1, id); it < p.items(1); it += p.workers) {
    const Item t = item_of(p, 1, it);
    fc2_products(a, sc, cn, w, t, slot);
    slot += t.stages;
  }
  for (int it = p.first(1, id); it < p.items(1); it += p.workers)
    fc2_finish(a, sc, cn, w, item_of(p, 1, it));

  // the last block to finish sets the counters back to zero
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = add_acq_rel(a.counters + cn.done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (last_block) {
    for (int i = threadIdx.x; i < cn.done; i += BLOCK) a.counters[i] = 0;
    __syncthreads();
    if (threadIdx.x == 0) a.counters[cn.done] = 0;
  }
}

Plan make_plan(int rows, int K, int F, int kc1, int kc2, int workers) {
  Plan p;
  p.rows = rows; p.K = K; p.F = F; p.kc1 = kc1; p.kc2 = kc2;
  p.workers = workers;
  return p;
}

}  // namespace

// The kernel's shared-memory allowance, once a device (setting it per shape
// made a later launch of another cooperative kernel at another shape fail).
extern "C" int favae_ffn_int8_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      ffn_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_ALLOWED));
}

// Blocks of the cooperative grid: one an SM if a block of `smem` bytes is
// resident, else 0; a negative CUDA error on failure.
extern "C" int favae_ffn_int8_grid(long long smem) {
  int dev = 0, sms = 0, occ = 0;
  if (smem > (long long)SMEM_ALLOWED) return 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, ffn_int8_kernel,
                                                        BLOCK, (size_t)smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return occ >= 1 ? sms : 0;
}

// Floats of scratch a call needs.
extern "C" long long favae_ffn_int8_scratch(int rows, int K, int F, int kc1,
                                            int kc2) {
  return (long long)scratch_layout(make_plan(rows, K, F, kc1, kc2, 1)).total;
}

// Ints of a stream's counters, and where fc1's finish and fc2's counters
// start.
extern "C" int favae_ffn_int8_counters(int K, int F, int* fin1, int* cnt2) {
  const Counters c = counter_layout(K, F);
  *fin1 = c.fin1;
  *cnt2 = c.cnt2;
  return c.total;
}

// Boxes the fullest worker holds, and the dynamic shared memory of a block.
extern "C" long long favae_ffn_int8_smem(int rows, int K, int F, int kc1,
                                         int kc2, int workers, int* slots) {
  const Plan p = make_plan(rows, K, F, kc1, kc2, workers);
  *slots = slots_of(p);
  return (long long)smem_bytes(p, *slots);
}

// The work items of product P (0 fc1, 1 fc2) in the kernel's order, five ints
// each (tile, chunk, worker, k0, k1) into `out` when it holds `cap` of them;
// returns how many there are.
extern "C" int favae_ffn_int8_items(int K, int F, int kc1, int kc2,
                                    int workers, int P, int* out, int cap) {
  const Plan p = make_plan(1, K, F, kc1, kc2, workers);
  const int n = p.items(P);
  for (int it = 0; it < n && it < cap; ++it) {
    const Item t = item_of(p, P, it);
    const int v[5] = {t.tile, t.chunk,
                      P == 0 ? it % workers : workers - 1 - it % workers,
                      t.k0, t.k1};
    for (int i = 0; i < 5; ++i) out[5 * it + i] = v[i];
  }
  return n;
}

// x, y (rows, K) bf16 (x 16-byte aligned); g_in (K,) f32; w1q (K, F) int8,
// s1 (F,) f32; w2q (F, K) int8, s2, c2 (K,) f32; scratch as sized above;
// counters: the stream's, zero; `grid` from favae_ffn_int8_grid. K and F
// multiples of 128, K at most 1536. Returns the CUDA error of the cooperative
// launch (0 on success; cudaErrorInvalidValue for shapes the plan does not
// hold, cudaErrorNotSupported where CUDA gives no tensor map).
extern "C" int favae_ffn_int8(const void* x, const void* g_in, const void* w1q,
                              const void* s1, const void* w2q, const void* s2,
                              const void* c2, void* scratch, void* counters,
                              void* y, int rows, int K, int F, int kc1, int kc2,
                              int grid, float eps, void* stream) {
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (K % TN || F % TN || K > MAX_K || F / TN > MAX_TILES1 || kc1 % SK ||
      kc1 > MAX_KC1 || kc2 % TN || rows < 1 || cdiv(K, kc1) > MAX_CH1 ||
      cdiv(F, kc2) > MAX_CH2)
    return static_cast<int>(cudaErrorInvalidValue);
  FfnParams a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.g_in = static_cast<const float*>(g_in);
  a.s1 = static_cast<const float*>(s1);
  a.s2 = static_cast<const float*>(s2);
  a.c2 = static_cast<const float*>(c2);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.scratch = static_cast<float*>(scratch);
  a.counters = static_cast<int*>(counters);
  a.p = make_plan(rows, K, F, kc1, kc2, WORKERS * grid);
  a.slots = slots_of(a.p);
  a.eps = eps;
  const size_t smem = smem_bytes(a.p, a.slots);
  if (a.slots > MAX_SLOTS || smem > SMEM_ALLOWED)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[2];
  const cuuint64_t d1[3] = {(cuuint64_t)F, (cuuint64_t)K, 1};
  const cuuint64_t d2[3] = {(cuuint64_t)K, (cuuint64_t)F, 1};
  if (!mma8::weight_map(&maps[0], w1q, 3, d1) ||
      !mma8::weight_map(&maps[1], w2q, 3, d2))
    return static_cast<int>(cudaErrorNotSupported);
  void* args[] = {&a, &maps[0], &maps[1]};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ffn_int8_kernel), dim3(grid), dim3(BLOCK), args,
      smem, static_cast<cudaStream_t>(stream)));
}
