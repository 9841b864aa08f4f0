"""Kernels (`ops/gn.py`, rows 2-3): the GroupNorm kernels' share of their
byte roofline in a reconstruction request, in %: the sum of their calls'
byte bounds over the sum of their device time."""

from benchmark.metrics_common import gn_roofline_pct


def read(record):
    return gn_roofline_pct(record, "gn_bytes_per_request")
