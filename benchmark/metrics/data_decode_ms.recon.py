"""Data layer (`data/pipeline.py`): the ms one loader worker took to
decode a batch (the port's `data.decode_s` over `data.batches`, timed
inside each job)."""

from benchmark.port_counters import ratio


def read(record):
    return ratio(record, "data.decode_s", "data.batches", 1e3)
