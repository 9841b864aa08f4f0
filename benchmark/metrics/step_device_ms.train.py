"""Train step (`train/`): device-busy ms per step, the union of the
device's operation intervals over the traced steps."""

from benchmark.metrics_common import busy_ms_per_item


def read(record):
    return busy_ms_per_item(record)
