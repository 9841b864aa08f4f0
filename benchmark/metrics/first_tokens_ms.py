"""Serving loop (`graphs.py` `run_steps`): the median over the window's
requests of the device time of tokens 0 and 1 together, the eager first
step and the capture of the token step's graph, which every request pays
(`sample_images(timings=)`'s CUDA events)."""

import statistics


def read(record):
    ms = [sum(r["token_ms"][:2])
          for r in record["window"].extra.get("timings", [])
          if len(r["token_ms"]) >= 2]
    return statistics.median(ms) if ms else None
