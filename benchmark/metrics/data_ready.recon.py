"""Data layer (`data/pipeline.py`): the share of batches whose decode had
finished when the consumer asked for them, in % (the port's `data.ready`
over `data.batches`)."""

from benchmark.port_counters import ratio


def read(record):
    return ratio(record, "data.ready", "data.batches", 100.0)
