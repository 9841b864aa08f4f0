"""Codec (`models/vqgan.py`, `codec.py`, `quantizer.py`, `blocks.py`):
device-busy ms per reconstruction request, the union of the device's
operation intervals over the traced requests."""

from benchmark.metrics_common import busy_ms_per_item


def read(record):
    return busy_ms_per_item(record)
