"""Serving loop (`graphs.py` `run_steps`): the host ms spent capturing the
token step's CUDA graph, a request (the port's `graphs.capture_s` over the
requests); 0.0 where no request captures."""

from benchmark.port_counters import per_item


def read(record):
    return per_item(record, "graphs.capture_s", 1e3)
