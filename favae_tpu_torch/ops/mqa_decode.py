"""The attention chain of the exact token step, one launch an attention
sublayer (kernel: Triton, `_mqa_decode_kernel`).

`GPT.sample`'s token step runs, between each attention sublayer's
projections (`to_q`, `to_kv` before; `to_out` after), the chain of
`MultiQueryAttention._attend` op by op: the null kv's cast and `cat` (in
self-attention a copy of the whole cache every token), the q scale, the
cache's `index_copy_`, the mask's `arange` and `le`, the relative
position bias's `index_select`, `embedding` and `pad`, two einsums with
their layout copies, the f32 cast, the bias add, the mask's `pad` and
`where`, the softmax and the cast back: ~30 launches a layer, each moving a
few KB. The JAX package's `jit` fuses the chain (favae_tpu/models/gpt.py,
no Pallas kernel); here one launch computes it:

- `self_attend(q, kv, cache, pos, null_kv, table, pos_indices)`, causal
  self-attention: writes the new kv row (b, 1, dh) into the cache
  (b, S, dh) at `pos` (a 0-dim integer tensor on the device, read there),
  scores the null slot (no bias) and the cache rows 0..pos with every
  head of q (b, 1, h dh), the projection's output unscaled, adds the
  relative position bias `table[pos_indices[pos, j], h]` (table (R, h),
  this rank's heads; its rows may be strided), masks the rows beyond pos,
  and returns P V as (b, 1, h dh);
- `cross_attend(q, kv, mask, null_kv)`, cross-attention against the text's
  kv (b, M, dh) with its mask (b, M) (the null slot always kept), no bias,
  nothing written.

Roundings are the plain sequence's (`self_attend_plain`,
`cross_attend_plain`): q scaled by dh^-0.5 in its dtype; each score
rounded to that dtype, as the einsum's output is, then f32; the bias add
and the softmax in f32; P rounded to the dtype; P V summed in f32 and
stored in the dtype.

One program a row of the CFG batch puts all its heads (padded to a power
of two, at least 16) through one `tl.dot` over the layer's single K/V
head: the K/V tile (every key row, at most a few tens of KB) is loaded once
and serves both products, the null's score and its share of P V are
computed beside them. A call moves ~0.3 MB at gpt2_medium (S 256, 8 rows),
~0.1 us at the HBM rate: latency bounds it, so the design is one launch
with as few dependent trips to memory as the chain allows (the position,
then its row of `pos_indices`, then the bias table's entries; the K/V tile
is loaded at once and the rows beyond the position zeroed after). Block
sizes follow the shapes (heads, key rows, dh), compiled at the first launch
of each (the eager first token of `graphs.run_steps`, before the capture).

CUDA tensors take the kernel; CPU tensors take the plain op sequence, which
is what the token step ran before the kernel, bit for bit. The kernel
agrees with it within a rounding of the stored dtype (its f32 sums run in
another order). The wrapper raises on what it does not take (a tensor that
records gradients, an input that is not contiguous, a device other than
the CPU or CUDA, mismatched shapes or dtypes): it never falls back.
`triton` is imported at the first launch, so this module imports without
it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e9  # large negative in place of -finfo.max (bf16-safe)

# kernel launches since the last reset (graphs.launch_counts)
LAUNCHES = {"mqa_decode": 0}

# triton.language and its CUDA extras, bound by _jit() at the first launch;
# the kernel body resolves `tl` and `gdc` through this module's globals
# when Triton compiles it
tl = gdc = None
_JIT = {}


def _mqa_decode_kernel(q_ptr, kv_ptr, keys_ptr, pos_ptr, null_ptr,
                       table_ptr, idx_ptr, mask_ptr, out_ptr, H, S,
                       table_stride, idx_stride, scale, neg,
                       SELF: "tl.constexpr", DH: "tl.constexpr",
                       BLOCK_H: "tl.constexpr", BLOCK_S: "tl.constexpr",
                       PREC: "tl.constexpr"):
    # launched as a programmatic dependent: the next kernel may start now
    # (a `rows_gemm` product streams its weights meanwhile); nothing is
    # read before the kernel before this one has completed
    gdc.gdc_launch_dependents()
    gdc.gdc_wait()
    # program b: row b of the CFG batch, every head against its S key rows
    # (the cache, or the text's kv) and the null slot; SELF is
    # self_attend's form, which writes the cache and adds the bias
    b = tl.program_id(0).to(tl.int64)
    h = tl.arange(0, BLOCK_H)
    d = tl.arange(0, DH)
    j = tl.arange(0, BLOCK_S)
    hm, jm = h < H, j < S
    dt = q_ptr.dtype.element_ty
    q = tl.load(q_ptr + (b * H + h[:, None]) * DH + d[None, :],
                mask=hm[:, None], other=0.0)
    q = (q.to(tl.float32) * scale).to(dt)
    null = tl.load(null_ptr + d).to(dt).to(tl.float32)
    k = tl.load(keys_ptr + (b * S + j[:, None]) * DH + d[None, :],
                mask=jm[:, None], other=0.0)
    if SELF:
        pos = tl.load(pos_ptr)
        new = tl.load(kv_ptr + b * DH + d).to(dt)
        inside = (pos >= 0) & (pos < S)
        tl.store(keys_ptr + (b * S + pos) * DH + d, new,
                 mask=(d < DH) & inside)
        keep = j <= pos
        k = tl.where((j == pos)[:, None], new[None, :],
                     tl.where(keep[:, None], k, 0.0)).to(dt)
        idx = tl.load(idx_ptr + pos * idx_stride + j, mask=jm & inside,
                      other=0)
    else:
        keep = tl.load(mask_ptr + b * S + j, mask=jm, other=0) != 0
        k = tl.where(keep[:, None], k, 0.0).to(dt)
    s = tl.dot(q, tl.trans(k), input_precision=PREC)
    s = s.to(dt).to(tl.float32)
    s0 = tl.sum(q.to(tl.float32) * null[None, :], axis=1).to(dt).to(
        tl.float32)
    if SELF:
        s += tl.load(table_ptr + idx[None, :] * table_stride + h[:, None],
                     mask=hm[:, None] & jm[None, :], other=0.0).to(tl.float32)
    s = tl.where(keep[None, :], s, neg)
    s = tl.where(jm[None, :], s, float("-inf"))
    m = tl.maximum(tl.max(s, axis=1), s0)
    e = tl.exp(s - m[:, None])
    e0 = tl.exp(s0 - m)
    total = tl.sum(e, axis=1) + e0
    p = (e / total[:, None]).to(dt)
    p0 = (e0 / total).to(dt).to(tl.float32)
    o = tl.dot(p, k, input_precision=PREC)
    o += p0[:, None] * null[None, :]
    tl.store(out_ptr + (b * H + h[:, None]) * DH + d[None, :], o.to(dt),
             mask=hm[:, None])


def _jit():
    global tl, gdc
    if not _JIT:
        import triton
        import triton.language
        import triton.language.extra.cuda

        tl, gdc = triton.language, triton.language.extra.cuda
        _JIT["mqa_decode"] = triton.jit(_mqa_decode_kernel)
    return _JIT


def _attend_plain(q, kv, null_kv, keep, bias):
    """`MultiQueryAttention._attend` of one query row: q (b, 1, h dh)
    unscaled, kv (b, m, dh) without the null, keep (b, m) bool, bias
    (1, h, 1, m + 1) f32 or None; (b, 1, h dh)."""
    b, dh = q.shape[0], kv.shape[-1]
    q = (q * dh ** -0.5).reshape(b, 1, -1, dh)
    null = null_kv.to(kv.dtype).expand(b, 1, dh)
    kv_full = torch.cat([null, kv], dim=1)
    sim = torch.einsum("bnhd,bmd->bhnm", q, kv_full).float()
    if bias is not None:
        sim = sim + bias
    cm = F.pad(keep, (1, 0), value=True)
    sim = torch.where(cm[:, None, None, :], sim, NEG_INF)
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bhnm,bmd->bnhd", attn.to(kv_full.dtype), kv_full)
    return out.reshape(b, 1, -1)


def self_attend_plain(q, kv, cache, pos, null_kv, table, pos_indices):
    """`self_attend`'s op sequence in PyTorch (see the module docstring)."""
    b, s, _ = cache.shape
    cache.index_copy_(1, pos.view(1), kv.to(cache.dtype))
    keep = (torch.arange(s, device=cache.device) <= pos).expand(b, -1)
    rows = pos_indices.index_select(0, pos.view(1))
    bias = F.pad(F.embedding(rows[:, :s], table).permute(2, 0, 1), (1, 0))
    return _attend_plain(q, cache, null_kv, keep, bias[None])


def cross_attend_plain(q, kv, mask, null_kv):
    """`cross_attend`'s op sequence in PyTorch."""
    return _attend_plain(q, kv, null_kv, mask, None)


def _check(q, keys, null_kv, *others, table=None):
    # the bias table's rows may be strided (a tp slice's columns)
    ts = (q, keys, null_kv) + others + (() if table is None else (table,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError("mqa_decode: tensors that record gradients (the "
                         "kernel has no backward; call it under "
                         "inference_mode)")
    for t in ts:
        rows = t.is_contiguous() or (t is table and t.stride(-1) == 1)
        if t.device != q.device or not rows:
            raise ValueError(f"mqa_decode: every input must be contiguous on "
                             f"{q.device}, got {tuple(t.shape)} on {t.device} "
                             f"strides {t.stride()}")
    if q.dtype != keys.dtype or q.dtype not in (torch.bfloat16, torch.float16,
                                                torch.float32):
        raise ValueError(f"mqa_decode: q {q.dtype} against keys {keys.dtype}")
    b, s, dh = keys.shape
    if (dh < 16 or dh & (dh - 1) or q.dim() != 3 or q.shape[:2] != (b, 1)
            or q.shape[2] % dh or null_kv.shape != (dh,)):
        raise ValueError(f"mqa_decode: q {tuple(q.shape)}, keys "
                         f"{tuple(keys.shape)}, null {tuple(null_kv.shape)}")


def _launch(q, kv, keys, pos, null_kv, table, pos_indices, mask, *,
            self_form: bool) -> torch.Tensor:
    # a pointer the form leaves out is passed as q, never touched
    if q.device.type != "cuda":
        raise ValueError(f"mqa_decode: unsupported device {q.device}")
    b, s, dh = keys.shape
    heads = q.shape[2] // dh
    block_s = max(16, 1 << (s - 1).bit_length())
    out = torch.empty_like(q)
    jit = _jit()
    with torch.cuda.device(q.device):
        jit["mqa_decode"][(b,)](
            q, kv if self_form else q, keys, pos if self_form else q, null_kv,
            table if self_form else q, pos_indices if self_form else q,
            q if self_form else mask.view(torch.uint8), out, heads, s,
            table.stride(0) if self_form else 0,
            pos_indices.stride(0) if self_form else 0, dh ** -0.5, NEG_INF,
            SELF=self_form, DH=dh,
            BLOCK_H=max(16, 1 << (heads - 1).bit_length()), BLOCK_S=block_s,
            PREC="ieee" if q.dtype == torch.float32 else "tf32",
            num_warps=8 if block_s >= 256 else 4, launch_pdl=True)
    LAUNCHES["mqa_decode"] += 1
    return out


def self_attend(q: torch.Tensor, kv: torch.Tensor, cache: torch.Tensor,
                pos: torch.Tensor, null_kv: torch.Tensor, table: torch.Tensor,
                pos_indices: torch.Tensor) -> torch.Tensor:
    """Causal self-attention of one token step (module docstring), the
    cache written at `pos` in place: one launch for CUDA tensors, the plain
    op sequence for CPU tensors."""
    if cache.device.type == "cpu":
        return self_attend_plain(q, kv, cache, pos, null_kv, table,
                                 pos_indices)
    _check(q, cache, null_kv, kv, pos, pos_indices, table=table)
    b, s, dh = cache.shape
    heads = q.shape[2] // dh
    if (kv.shape != (b, 1, dh) or pos.dim() or pos.is_floating_point()
            or table.dim() != 2 or table.shape[1] != heads
            or pos_indices.dim() != 2 or pos_indices.shape[1] < s):
        raise ValueError(f"mqa_decode: kv {tuple(kv.shape)}, pos "
                         f"{tuple(pos.shape)} {pos.dtype}, table "
                         f"{tuple(table.shape)} strides {table.stride()}, "
                         f"pos_indices {tuple(pos_indices.shape)} for "
                         f"{heads} heads and {s} cache rows")
    return _launch(q, kv, cache, pos, null_kv, table, pos_indices, None,
                   self_form=True)


def cross_attend(q: torch.Tensor, kv: torch.Tensor, mask: torch.Tensor,
                 null_kv: torch.Tensor) -> torch.Tensor:
    """Cross-attention of one token step against the text's kv (module
    docstring): one launch for CUDA tensors, the plain op sequence for CPU
    tensors."""
    if kv.device.type == "cpu":
        return cross_attend_plain(q, kv, mask, null_kv)
    _check(q, kv, null_kv, mask)
    if mask.dtype != torch.bool or mask.shape != kv.shape[:2]:
        raise ValueError(f"mqa_decode: mask {tuple(mask.shape)} {mask.dtype} "
                         f"against kv {tuple(kv.shape)}")
    return _launch(q, None, kv, None, null_kv, None, None, mask,
                   self_form=False)
