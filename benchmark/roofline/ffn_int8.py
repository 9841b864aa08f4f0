"""Row 5's yardstick: the bytes a call of the int8 feed-forward block must
move at the configuration's shapes, counted from `GPTConfig`'s widths and
the call's rows, never from the port's tensors.

A call of the block (LayerNorm -> fc1 -> GELU -> LayerNorm -> fc2 ->
residual) on `rows` rows of width K = n_embed, F = 4 K: the int8 fc1
(K x F) and the gamma-folded fc2 (F x K), fc1's f32 scales (F) and fc2's
(K), fc2's f32 column sums (K), the f32 `gamma_in` (K), and the bf16 x
read and y written (rows x K), each once. Its operations, 4 rows K F at
the int8 peak, take under 3 % of its bytes' time at 8 rows: the bound is
the bytes.
"""

from __future__ import annotations

MULT = 4     # the feed-forward's width over n_embed (`FeedForward`)


def call_bytes(rows: int, k: int, f: int) -> int:
    return 2 * k * f + 4 * (f + 2 * k) + 4 * k + 2 * 2 * rows * k


def gpt_call_bytes(cfg, rows: int) -> int:
    """A call's bytes for a `GPTConfig` at `rows` CFG rows."""
    return call_bytes(rows, cfg.n_embed, MULT * cfg.n_embed)

