"""Whole request: a reconstruction request's counted matmul and
convolution FLOPs (from the reference's modules at the configuration's
shapes) over the untraced requests' time a request and the bf16 peak,
in %."""

from benchmark.metrics_common import mfu_pct


def read(record):
    return mfu_pct(record, "flops_per_request")
