"""Serving loop (`models/txt_cond.py`, `models/gpt.py` `GPT.sample`,
`graphs.py`): the median device time of a token step over tokens 2-255 of
every request of the window, from `sample_images(timings=)`'s CUDA events
(tokens 0 and 1 hold the eager first step and the graph's capture)."""

import statistics


def read(record):
    ms = [t for r in record["window"].extra.get("timings", [])
          for t in r["token_ms"][2:]]
    return statistics.median(ms) if ms else None
