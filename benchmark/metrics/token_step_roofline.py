"""Serving loop: the token step's share of its roofline, in %: its least
time, the larger of its FLOPs over the bf16 peak and its bytes (the GPT's
weights read once in bf16 and the KV caches at the mean position, from the
configuration's shapes) over the HBM rate, against its median time
(`token_ms`). The bytes bind at these shapes."""

from benchmark import roofline
from benchmark.metrics_common import counts, median_token_s


def read(record):
    t = median_token_s(record)
    if t is None:
        return None
    c = counts(record)
    least, _ = roofline.bound(c["token_bytes"], c["token_flops"])
    return 100.0 * least / t
