"""Kernels (`ops/gn.py`, `csrc/gn_bwd_sums.cu`, rows 2-4): the GroupNorm
kernels' share of their byte roofline in a train step, in %: the sum of
their calls' byte bounds over the sum of their device time."""

from benchmark.metrics_common import gn_roofline_pct


def read(record):
    return gn_roofline_pct(record, "gn_bytes_per_step")
