"""Data layer (`data/pipeline.py`): the host ms the consumer waited for a
batch, a batch handed over, read inside the loader (the port's
`data.wait_s` over `data.batches`: the `data.wait` span, an epoch's first
submissions included)."""

from benchmark.port_counters import ratio


def read(record):
    return ratio(record, "data.wait_s", "data.batches", 1e3)
