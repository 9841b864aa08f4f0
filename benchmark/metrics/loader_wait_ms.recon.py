"""Data layer (`data/pipeline.py`): the mean host wait for the port's
loader to hand over a batch, per request of the window (the benchmark's
`loader` span around the loader's next())."""

from benchmark.metrics_common import mean_span_ms


def read(record):
    return mean_span_ms(record, "loader")
