"""Device: the share of the traced window in which no operation ran on the
device, in %."""

from benchmark.metrics_common import idle_pct


def read(record):
    return idle_pct(record)
