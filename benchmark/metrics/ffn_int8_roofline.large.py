"""Kernels (`csrc/ffn_int8.cu`, row 5): the int8 feed-forward block's share
of its byte roofline, in %: the bytes a call must move at the
configuration's widths and the cell's CFG rows (`roofline.ffn_int8`) over
3.35 TB/s, against the device time a call of the `ffn_int8_kernel` kernel
in the trace (a cooperative launch, not a programmatic dependent: its span
is its own execution). None where the trace holds no such kernel."""

from benchmark import roofline
from benchmark.cat import cat_config
from benchmark.reference import config as RC
from benchmark.roofline.ffn_int8 import gpt_call_bytes


def read(record):
    t = record["trace"]
    if t is None:
        return None
    names = [k for k in t["kernel_s"] if "ffn_int8_kernel" in k]
    dev = sum(t["kernel_s"][k] for k in names)
    traced = sum(t["kernel_calls"][k] for k in names)
    if dev <= 0 or traced == 0:
        return None
    cfg = cat_config(RC, record["cell"].config).gpt
    nbytes = gpt_call_bytes(cfg, record["window"].extra["rows"])
    return 100.0 * (nbytes / roofline.HBM_BYTES_PER_S) / (dev / traced)
