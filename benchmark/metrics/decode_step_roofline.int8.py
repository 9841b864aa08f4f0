"""Kernels (`csrc/decode_step.cu`, row 6): the int8 whole-step kernel's
share of its byte roofline, in %: the bytes a launch must stream (the
port's `decode_step.bytes` over `launches.decode_step`, every launch of the
run: int8 weights, their scales, the caches at the position) over the HBM
rate, against the device time a call of the `decode_step_kernel` kernel in
the trace. None where the program keeps no such counter or the trace
holds no such kernel."""

from benchmark import roofline
from benchmark.port_counters import counters_of


def read(record):
    t, got = record["trace"], counters_of(record)
    if t is None or got is None:
        return None
    nbytes = got[0].get("decode_step.bytes")
    calls = got[0].get("launches.decode_step")
    names = [k for k in t["kernel_s"] if "decode_step_kernel" in k]
    dev = sum(t["kernel_s"][k] for k in names)
    traced = sum(t["kernel_calls"][k] for k in names)
    if not nbytes or not calls or dev <= 0 or traced == 0:
        return None
    least = nbytes / calls / roofline.HBM_BYTES_PER_S
    return 100.0 * least / (dev / traced)
