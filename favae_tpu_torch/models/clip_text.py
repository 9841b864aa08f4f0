"""CLIP text tower and its byte-level BPE tokenizer (port of
favae_tpu/models/clip_text.py; reference: CLIP/clip/model.py:246-376).

`CLIPTextEncoder` returns both the projected 77-token sequence, which CAT
uses as cross-attention memory, and the EOT-pooled embedding. Token and
learned positional embeddings, a pre-norm transformer with a causal mask
and QuickGELU MLPs, `ln_final`, a linear text projection. The parameters
are named as OpenAI CLIP's text branch
(`transformer.resblocks.{i}.attn.in_proj_weight`, ...), so its state_dict
loads directly (`convert.load_reference_clip_text`).

Tokenizer: the package's own copy of the byte-level BPE (lower-casing,
whitespace clean-up, <|startoftext|>/<|endoftext|> wrapping, a zero-padded
context of 77). Its word pattern is compiled at first use, with the `regex`
package where it is installed and else with a standard-library `re` pattern;
see `word_pattern`.
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Iterable, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from favae_tpu_torch.config import CLIPTextConfig


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class _Attention(nn.Module):
    """Multi-head self-attention with packed q/k/v projections, named as
    nn.MultiheadAttention's parameters. Scores and softmax in f32."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, h, attn_mask, dtype):
        b, n, d = h.shape
        dh = d // self.heads
        qkv = F.linear(h, self.in_proj_weight.to(dtype),
                       self.in_proj_bias.to(dtype))
        q, k, v = (t.reshape(b, n, self.heads, dh) for t in qkv.chunk(3, -1))
        sim = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (dh ** -0.5)
        if attn_mask is not None:
            sim = sim + attn_mask[None, None]
        att = torch.softmax(sim, dim=-1).to(dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, n, d)
        return F.linear(out, self.out_proj.weight.to(dtype),
                        self.out_proj.bias.to(dtype))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(width, width * 4),
                                  "c_proj": nn.Linear(width * 4, width)})

    def _linear(self, lin, x):
        return F.linear(x, lin.weight.to(self.dtype), lin.bias.to(self.dtype))

    def forward(self, x, attn_mask=None):
        h = self.ln_1(x.float()).to(self.dtype)
        x = x + self.attn(h, attn_mask, self.dtype).to(x.dtype)
        h = self._linear(self.mlp["c_fc"], self.ln_2(x.float()).to(self.dtype))
        h = self._linear(self.mlp["c_proj"], quick_gelu(h))
        return x + h.to(x.dtype)


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype) for _ in range(layers))


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.token_embedding = nn.Embedding(c.vocab_size, c.width)
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        self.positional_embedding = nn.Parameter(
            torch.randn(c.context_length, c.width) * 0.01)
        self.transformer = _Transformer(c.width, c.layers, c.heads, dtype)
        self.ln_final = nn.LayerNorm(c.width, eps=1e-5)
        self.text_projection = nn.Parameter(
            torch.randn(c.width, c.embed_dim) * c.width ** -0.5)

    def forward(self, text_ids):
        """text_ids (B, 77) integer -> (token_embeds (B, 77, embed_dim),
        pooled (B, embed_dim)), both projected, as the reference's modified
        encode_text (CLIP/clip/model.py:346-360)."""
        x = self.token_embedding(text_ids) + self.positional_embedding[None]
        n = self.cfg.context_length
        # causal additive mask (reference: model.py:332-338)
        mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
        for block in self.transformer.resblocks:
            x = block(x, mask)
        x = self.ln_final(x.float()) @ self.text_projection
        pooled = x[torch.arange(x.shape[0], device=x.device),
                   text_ids.argmax(dim=-1)]
        return x, pooled


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

@lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (GPT-2/CLIP convention)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


_SPECIALS = r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"


def stdlib_word_pattern():
    """The word pattern with the standard library's `re`: `[^\\W\\d_]` for a
    letter and `\\d` for a numeral. It differs from CLIP's own pattern only
    outside ASCII and Latin text: `\\d` is Unicode class Nd, so numerals of
    classes Nl and No (Roman numeral signs, superscripts, fractions such as
    "½") are not single numeral tokens here: `[^\\W\\d_]` takes every
    alphanumeric that is not Nd, so these characters join the letter runs
    beside them."""
    return re.compile(_SPECIALS + r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
                      re.IGNORECASE)


@lru_cache()
def word_pattern():
    """(compiled word pattern, "regex" or "re"): CLIP's own pattern (runs of
    letters \\p{L}, single numerals \\p{N}, runs of anything else that is not
    white space) with the `regex` package where it is installed, else
    `stdlib_word_pattern`."""
    try:
        import regex
    except ImportError:
        return stdlib_word_pattern(), "re"
    return regex.compile(
        _SPECIALS + r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        regex.IGNORECASE), "regex"


class BPETokenizer:
    """Byte-level BPE with the CLIP merges file
    (semantics of reference: CLIP/clip/simple_tokenizer.py:62-132)."""

    def __init__(self, bpe_path: Optional[str] = None,
                 merges: Optional[List[str]] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if merges is None:
            if bpe_path is None:
                raise ValueError("provide bpe_path or merges")
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
            merges = merges[1: 49152 - 256 - 2 + 1]
        merge_pairs = [tuple(m.split()) for m in merges if m]

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merge_pairs:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = {p: i for i, p in enumerate(merge_pairs)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in word_pattern()[0].findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            out.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return out

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


def tokenize(tokenizer: BPETokenizer, texts: Union[str, List[str]],
             context_length: int = 77, truncate: bool = True) -> np.ndarray:
    """SOT/EOT wrapping, fixed zero-padded context
    (reference: CLIP/clip/clip_custom.py:204-244)."""
    if isinstance(texts, str):
        texts = [texts]
    result = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        ids = [tokenizer.sot] + tokenizer.encode(t) + [tokenizer.eot]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"input too long: {t!r}")
            ids = ids[:context_length]
            ids[-1] = tokenizer.eot
        result[i, : len(ids)] = ids
    return result
