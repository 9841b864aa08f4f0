"""Whole step: a token step's FLOPs (the GPT's projections and attention
for the request's CFG rows, counted from the configuration's shapes) over
its median time (`token_ms`) and the bf16 peak, in %."""

from benchmark import roofline
from benchmark.metrics_common import counts, median_token_s


def read(record):
    t = median_token_s(record)
    if t is None:
        return None
    return 100.0 * counts(record)["token_flops"] / (
        t * roofline.PEAK_FLOPS["bfloat16"])
