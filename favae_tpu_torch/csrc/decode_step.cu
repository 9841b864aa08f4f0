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
//    1  q and kv_t projections of LN(x)            (int8 W_q, bf16 W_kv)
//    2  self-attention, one item per (row, head); kv_t enters the cache
//    3  out projection                             (int8)
//    4  one block a row: x += LN(of), xn = LN(x)
//    5  cross q projection   6  cross-attention   7  out projection
//    8  one block a row: x += LN(of), xn = LN(x)
//    9  fc1                                        (int8)
//   10  fc2 of gelu(fc1), mid LayerNorm folded     (int8, gamma-folded)
//   11  one block a row: x += inv * (acc * s2 - mu * c2), xn for the next
//       layer, or the bf16 store of x after the last one
// The f32 hidden state, xn, the attention output and the partial products
// live in a small global scratch that stays in L2. Bound: the bytes of all
// layers' weights (about 0.6 GB a token at gpt2_medium); the kernel's own cost on
// top is the 11 L barriers and the short dependent phases between them.
//
// Each (row, head) attends its own [null | cache[:pos + 1]] directly; the
// cache row `pos` is written in place by the head-0 item of its row, and the
// other heads of that row use the same bf16 values from shared memory, so no
// item reads a cache row that another block writes in the same launch. Cache
// rows beyond pos are neither read nor trusted.
#include <cooperative_groups.h>

#include "int8_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace favae;

constexpr int DH = 64;  // head width the attention items are written for
// dynamic shared memory the kernel is allowed, set once whatever the shapes
constexpr size_t SMEM_ALLOWED = 160 * 1024;

struct DecodeParams {
  const __nv_bfloat16* x;         // (rows, d)
  __nv_bfloat16* caches;          // (L, rows, S, DH); row pos written in place
  const __nv_bfloat16* cross_kv;  // (L, rows, M, DH), slot 0 the null kv
  const float* cross_bias;        // (rows, M)
  const float* rel_rows;          // (L, heads, S + 1)
  const int8_t* wq_s;             // (L, d, inner)
  const float* sq_s;              // (L, inner)
  const int8_t* wo_s;             // (L, inner, d)
  const float* so_s;              // (L, d)
  const int8_t* wq_c;
  const float* sq_c;
  const int8_t* wo_c;
  const float* so_c;
  const __nv_bfloat16* wkv;       // (L, d, DH)
  const float* null_kv;           // (L, DH)
  const float* norms;             // (L, 5, d)
  const int8_t* w1;               // (L, d, F)
  const float* s1;                // (L, F)
  const int8_t* w2;               // (L, F, d)
  const float* s2;                // (L, d)
  const float* c2;                // (L, d)
  __nv_bfloat16* x_out;           // (rows, d)
  float* scratch;
  unsigned long long* clock;      // 1 + 11 L phase-end times in ns, or null
  int L, rows, d, heads, S, M, F, pos;
  int kc_q, kc_o, kc_1, kc_2;
  float eps;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Block 0 notes the time a phase ended (the barrier after it was passed),
// for favae_tpu_torch/cli/profile_decode.py.
__device__ __forceinline__ void note_time(const DecodeParams& p, int& n) {
  if (p.clock != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.clock[n] = t;
  }
  ++n;
}

// Offsets of the scratch segments, in floats.
struct Scratch {
  size_t xst, xn, ao, part_q, part_kv, part_o, part1, part2, stat, total;
};

__host__ __device__ inline Scratch scratch_layout(int rows, int d, int inner,
                                                  int F, int kc_q, int kc_o,
                                                  int kc_1, int kc_2) {
  Scratch s;
  size_t o = 0;
  s.xst = o;      o += (size_t)rows * d;
  s.xn = o;       o += (size_t)rows * d;
  s.ao = o;       o += (size_t)rows * inner;
  s.part_q = o;   o += (size_t)cdiv(d, kc_q) * rows * inner;
  s.part_kv = o;  o += (size_t)cdiv(d, kc_q) * rows * DH;
  s.part_o = o;   o += (size_t)cdiv(inner, kc_o) * rows * d;
  s.part1 = o;    o += (size_t)cdiv(d, kc_1) * rows * F;
  s.part2 = o;    o += (size_t)cdiv(F, kc_2) * rows * d;
  s.stat = o;     o += (size_t)cdiv(F, kc_2) * rows * 2;
  s.total = o;
  return s;
}

// kv_t = xn @ W_kv (bf16 weights, DH columns): items (row group, chunk of d),
// a lane owning 2 columns. part_kv (chunks, rows, DH).
__device__ void phase_kv(const float* xn, int rows, int d,
                         const __nv_bfloat16* __restrict__ wkv, int kc,
                         float* part_kv, float* xs, float* red, int block,
                         int nblocks) {
  const int nchunk = cdiv(d, kc);
  const int items = cdiv(rows, MR) * nchunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int it = block; it < items; it += nblocks) {
    const int c = it % nchunk;
    const int r0 = it / nchunk * MR;
    const int k0 = c * kc, k1 = min(d, k0 + kc);
    const int rv = min(MR, rows - r0);
    fill_rows(xs, xn, d, r0, rv, k0, k1);
    float acc[MR][2];
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[m][0] = acc[m][1] = 0.f;
    const __nv_bfloat162* wl =
        reinterpret_cast<const __nv_bfloat162*>(wkv + lane * 2);
    for (int kb = k0 + warp; kb < k1; kb += WARPS * UNROLL) {
      __nv_bfloat162 wv[UNROLL];  // rows past the chunk repeat its last row
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        wv[u] = wl[(size_t)min(kb + WARPS * u, k1 - 1) * (DH / 2)];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = kb + WARPS * u;
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
    __syncthreads();
    for (int o = threadIdx.x; o < MR * DH; o += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < WARPS; ++ww) s += red[ww * MR * DH + o];
      const int m = o / DH;
      if (m < rv)
        part_kv[((size_t)c * rows + r0 + m) * DH + o % DH] = s;
    }
    __syncthreads();
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
                            int row, int head, float* sm) {
  const int inner = p.heads * DH;
  const int tid = threadIdx.x;
  float* qs = sm;               // DH
  float* kv_null = sm + DH;     // DH
  float* kv_new = sm + 2 * DH;  // DH
  float* sh = sm + 3 * DH;      // WARPS
  float* og = sm + 3 * DH + WARPS;    // WARPS x DH
  float* pr = og + WARPS * DH;        // n_slots scores, then probabilities
  const int n_slots = SELF ? p.pos + 2 : p.M;
  const int nkq = cdiv(p.d, p.kc_q);
  const float* scr = p.scratch;

  if (tid < DH) {
    const int col = head * DH + tid;
    const float a = sum_strided(
        scr + sc.part_q + (size_t)row * inner + col, (size_t)p.rows * inner, nkq);
    const float* sq = (SELF ? p.sq_s : p.sq_c) + (size_t)l * inner;
    qs[tid] = bf16_round(a * sq[col] * 0.125f);  // DH^-0.5
  } else if (SELF && tid < 2 * DH) {
    const int dd = tid - DH;
    const float a = sum_strided(scr + sc.part_kv + (size_t)row * DH + dd,
                                (size_t)p.rows * DH, nkq);
    const __nv_bfloat16 v = __float2bfloat16(a);
    kv_new[dd] = __bfloat162float(v);
    if (head == 0)
      p.caches[(((size_t)l * p.rows + row) * p.S + p.pos) * DH + dd] = v;
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
    if (SELF && (j == 0 || j == p.pos + 1)) {
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

  // p @ v: warp g takes every 8th slot, a lane two neighbouring dims; four
  // slots' loads in flight, the order of the additions fixed
  const int d2 = 2 * (tid & 31), grp = tid >> 5;
  auto kv_at = [&](int j) -> float2 {
    if (SELF && j == 0) return make_float2(kv_null[d2], kv_null[d2 + 1]);
    if (SELF && j == p.pos + 1) return make_float2(kv_new[d2], kv_new[d2 + 1]);
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        kv + (size_t)(SELF ? j - 1 : j) * DH + d2));
  };
  float2 o4[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) o4[e] = make_float2(0.f, 0.f);
  int j = grp;
  for (; j + 3 * WARPS < n_slots; j += 4 * WARPS) {
    float2 v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = kv_at(j + e * WARPS);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o4[e].x = fmaf(pr[j + e * WARPS], v[e].x, o4[e].x);
      o4[e].y = fmaf(pr[j + e * WARPS], v[e].y, o4[e].y);
    }
  }
  for (; j < n_slots; j += WARPS) {
    const float2 v = kv_at(j);
    o4[0].x = fmaf(pr[j], v.x, o4[0].x);
    o4[0].y = fmaf(pr[j], v.y, o4[0].y);
  }
  og[grp * DH + d2] = (o4[0].x + o4[1].x) + (o4[2].x + o4[3].x);
  og[grp * DH + d2 + 1] = (o4[0].y + o4[1].y) + (o4[2].y + o4[3].y);
  __syncthreads();
  if (tid < DH) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < WARPS; ++g) a += og[g * DH + tid];
    p.scratch[sc.ao + (size_t)row * inner + head * DH + tid] = bf16_round(a);
  }
  __syncthreads();
}

// After an out projection, one block a row: x += LN(of) * g_out, then the
// next projection's input xn = bf16(LN(x) * g_next).
__device__ void attn_row_finish(const DecodeParams& p, const Scratch& sc,
                                int row, const float* __restrict__ so,
                                const float* __restrict__ g_out,
                                const float* __restrict__ g_next, float* buf,
                                float* sh) {
  const int d = p.d, nko = cdiv(p.heads * DH, p.kc_o);
  float* scr = p.scratch;
  sum_chunks_row(buf, scr + sc.part_o + (size_t)row * d, nko,
                 (size_t)p.rows * d, d);
  for (int c = threadIdx.x; c < d; c += THREADS) buf[c] *= so[c];
  __syncthreads();
  float rstd;
  const float mean = row_stats(buf, d, p.eps, sh, rstd);
  for (int c = threadIdx.x; c < d; c += THREADS) {
    const float xv = __ldcg(scr + sc.xst + (size_t)row * d + c) +
                     (buf[c] - mean) * rstd * g_out[c];
    scr[sc.xst + (size_t)row * d + c] = xv;
    buf[c] = xv;
  }
  __syncthreads();
  row_norm_out(buf, d, g_next, p.eps, sh, scr + sc.xn + (size_t)row * d);
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 2)
decode_step_kernel(const DecodeParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int d = p.d, inner = p.heads * DH, F = p.F, rows = p.rows;
  const int kc_max = max(max(p.kc_q, p.kc_o), max(p.kc_1, p.kc_2));
  float* xs = smem;  // item activations, or one row of d floats
  float* red = smem + max(kc_max * MR, d + WARPS);
  const Scratch sc = scratch_layout(rows, d, inner, F, p.kc_q, p.kc_o, p.kc_1,
                                    p.kc_2);
  float* scr = p.scratch;
  const int block = blockIdx.x, nblocks = gridDim.x;
  float* sh = xs + d;  // block reductions of the row passes
  int phase = 0;

  // x -> f32 state, and the first layer's xn
  for (int row = block; row < rows; row += nblocks) {
    for (int c = threadIdx.x; c < d; c += THREADS) {
      const float v = __bfloat162float(p.x[(size_t)row * d + c]);
      scr[sc.xst + (size_t)row * d + c] = v;
      xs[c] = v;
    }
    __syncthreads();
    row_norm_out(xs, d, p.norms, p.eps, sh, scr + sc.xn + (size_t)row * d);
    __syncthreads();
  }
  grid.sync();
  note_time(p, phase);

  for (int l = 0; l < p.L; ++l) {
    const float* norms = p.norms + (size_t)l * 5 * d;
    for (int branch = 0; branch < 2; ++branch) {  // self, then cross
      const bool self = branch == 0;
      const int8_t* wq = (self ? p.wq_s : p.wq_c) + (size_t)l * d * inner;
      const int8_t* wo = (self ? p.wo_s : p.wo_c) + (size_t)l * inner * d;
      const float* so = (self ? p.so_s : p.so_c) + (size_t)l * d;

      phase_proj(scr + sc.xn, d, rows, d, inner, wq, p.kc_q, scr + sc.part_q,
                 xs, red, block, nblocks);
      if (self)  // the last blocks take the few kv items
        phase_kv(scr + sc.xn, rows, d, p.wkv + (size_t)l * d * DH, p.kc_q,
                 scr + sc.part_kv, xs, red, nblocks - 1 - block, nblocks);
      grid.sync();
      note_time(p, phase);

      for (int it = block; it < rows * p.heads; it += nblocks) {
        if (self)
          attend_item<true>(p, sc, l, it / p.heads, it % p.heads, red);
        else
          attend_item<false>(p, sc, l, it / p.heads, it % p.heads, red);
      }
      grid.sync();
      note_time(p, phase);

      phase_proj(scr + sc.ao, inner, rows, inner, d, wo, p.kc_o,
                 scr + sc.part_o, xs, red, block, nblocks);
      grid.sync();
      note_time(p, phase);

      for (int row = block; row < rows; row += nblocks)
        attn_row_finish(p, sc, row, so, norms + (self ? 1 : 3) * d,
                        norms + (self ? 2 : 4) * d, xs, sh);
      grid.sync();
      note_time(p, phase);
    }

    phase_proj(scr + sc.xn, d, rows, d, F, p.w1 + (size_t)l * d * F, p.kc_1,
               scr + sc.part1, xs, red, block, nblocks);
    grid.sync();
    note_time(p, phase);

    phase_fc2(scr + sc.part1, cdiv(d, p.kc_1), p.s1 + (size_t)l * F, rows, F, d,
              p.w2 + (size_t)l * F * d, p.kc_2, scr + sc.part2, scr + sc.stat,
              xs, red, block, nblocks);
    grid.sync();
    note_time(p, phase);

    const bool last = l + 1 == p.L;
    for (int row = block; row < rows; row += nblocks) {
      ffn_row_finish(xs, scr + sc.xst, nullptr, scr + sc.part2, scr + sc.stat,
                     cdiv(F, p.kc_2), rows, row, d, F, p.s2 + (size_t)l * d,
                     p.c2 + (size_t)l * d, p.eps);
      if (last) {
        for (int c = threadIdx.x; c < d; c += THREADS)
          p.x_out[(size_t)row * d + c] = __float2bfloat16(xs[c]);
      } else {
        for (int c = threadIdx.x; c < d; c += THREADS)
          scr[sc.xst + (size_t)row * d + c] = xs[c];
        row_norm_out(xs, d, norms + 5 * d, p.eps, sh,
                     scr + sc.xn + (size_t)row * d);
      }
      __syncthreads();
    }
    if (!last) grid.sync();
    note_time(p, phase);
  }
}

size_t smem_bytes(const DecodeParams& p) {
  const int kc_max = max(max(p.kc_q, p.kc_o), max(p.kc_1, p.kc_2));
  const int a = max(kc_max * MR, p.d + WARPS);
  const int b = max(RED_FLOATS, (3 + WARPS) * DH + WARPS + max(p.S + 1, p.M));
  return (size_t)(a + b) * sizeof(float);
}

}  // namespace

// Floats of scratch one launch needs.
extern "C" long long favae_decode_step_scratch(int rows, int d, int heads,
                                               int F, int kc_q, int kc_o,
                                               int kc_1, int kc_2) {
  return (long long)scratch_layout(rows, d, heads * DH, F, kc_q, kc_o, kc_1,
                                   kc_2).total;
}

// Blocks of the cooperative grid for these shapes: the SM count times
// min(blocks_per_sm, what the occupancy query allows); 0 if none fits, a
// negative CUDA error on failure.
extern "C" int favae_decode_step_grid(int d, int S, int M, int kc_q, int kc_o,
                                      int kc_1, int kc_2, int blocks_per_sm) {
  DecodeParams p = {};
  p.d = d; p.S = S; p.M = M;
  p.kc_q = kc_q; p.kc_o = kc_o; p.kc_1 = kc_1; p.kc_2 = kc_2;
  const size_t smem = smem_bytes(p);
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
  return sms * min(occ, blocks_per_sm);
}

// One decode step. Pointers as in DecodeParams (`clock` may be null); `grid` from
// favae_decode_step_grid for the same shapes. Returns the CUDA error of the
// cooperative launch (0 on success).
extern "C" int favae_decode_step(
    const void* x, void* caches, const void* cross_kv, const void* cross_bias,
    const void* rel_rows, const void* wq_s, const void* sq_s, const void* wo_s,
    const void* so_s, const void* wq_c, const void* sq_c, const void* wo_c,
    const void* so_c, const void* wkv, const void* null_kv, const void* norms,
    const void* w1, const void* s1, const void* w2, const void* s2,
    const void* c2, void* x_out, void* scratch, void* clock, int L, int rows,
    int d,
    int heads, int S, int M, int F, int pos, int kc_q, int kc_o, int kc_1,
    int kc_2, float eps, int grid, void* stream) {
  DecodeParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.caches = static_cast<__nv_bfloat16*>(caches);
  p.cross_kv = static_cast<const __nv_bfloat16*>(cross_kv);
  p.cross_bias = static_cast<const float*>(cross_bias);
  p.rel_rows = static_cast<const float*>(rel_rows);
  p.wq_s = static_cast<const int8_t*>(wq_s);
  p.sq_s = static_cast<const float*>(sq_s);
  p.wo_s = static_cast<const int8_t*>(wo_s);
  p.so_s = static_cast<const float*>(so_s);
  p.wq_c = static_cast<const int8_t*>(wq_c);
  p.sq_c = static_cast<const float*>(sq_c);
  p.wo_c = static_cast<const int8_t*>(wo_c);
  p.so_c = static_cast<const float*>(so_c);
  p.wkv = static_cast<const __nv_bfloat16*>(wkv);
  p.null_kv = static_cast<const float*>(null_kv);
  p.norms = static_cast<const float*>(norms);
  p.w1 = static_cast<const int8_t*>(w1);
  p.s1 = static_cast<const float*>(s1);
  p.w2 = static_cast<const int8_t*>(w2);
  p.s2 = static_cast<const float*>(s2);
  p.c2 = static_cast<const float*>(c2);
  p.x_out = static_cast<__nv_bfloat16*>(x_out);
  p.scratch = static_cast<float*>(scratch);
  p.clock = static_cast<unsigned long long*>(clock);
  p.L = L; p.rows = rows; p.d = d; p.heads = heads; p.S = S; p.M = M;
  p.F = F; p.pos = pos;
  p.kc_q = kc_q; p.kc_o = kc_o; p.kc_1 = kc_1; p.kc_2 = kc_2;
  p.eps = eps;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(decode_step_kernel), dim3(grid), dim3(THREADS),
      args, smem_bytes(p), static_cast<cudaStream_t>(stream)));
}
