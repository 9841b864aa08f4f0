"""Whole step: a train step's counted matmul and convolution FLOPs
(forward and backward, from the reference's modules at the configuration's
shapes) over the untraced steps' time a step and the bf16 peak, in %."""

from benchmark.metrics_common import mfu_pct


def read(record):
    return mfu_pct(record, "flops_per_step")
