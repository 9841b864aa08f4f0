"""Kernels (`csrc/vq_nearest.cu`, row 1): the code search's share of its
compute roofline, in %: a call's 2 N K D operations (the port's `vq.macs`
over `launches.vq_nearest`, every call of the run) at the bf16 peak, the
rate no implementation of this work beats, over the device time a call of
the `vq_argmax` kernels in the trace. None where the program keeps no
such counter or the trace holds no such kernel."""

from benchmark import roofline
from benchmark.port_counters import counters_of


def read(record):
    t, got = record["trace"], counters_of(record)
    if t is None or got is None:
        return None
    macs, calls = got[0].get("vq.macs"), got[0].get("launches.vq_nearest")
    names = [k for k in t["kernel_s"] if "vq_argmax" in k]
    dev = sum(t["kernel_s"][k] for k in names)
    traced = sum(t["kernel_calls"][k] for k in names)
    if not macs or not calls or dev <= 0 or traced == 0:
        return None
    least = 2.0 * macs / calls / roofline.PEAK_FLOPS["bfloat16"]
    return 100.0 * least / (dev / traced)
