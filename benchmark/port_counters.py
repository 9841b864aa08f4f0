"""The port's counters (`favae_tpu_torch.profiling.counters()`) as the
per-layer readers of a traced run see them: the process's counters when
the reader runs, over every work item of the run (set-up's and the
window's; the serving cells' checks call nothing of the port). A program
that keeps no counters, or a run without a trace, gives None."""

from __future__ import annotations

from typing import Dict, Optional, Tuple


def snapshot() -> Optional[Dict[str, float]]:
    try:
        from favae_tpu_torch.profiling import counters
    except ImportError:
        return None
    return counters()


def counters_of(record) -> Optional[Tuple[Dict[str, float], int]]:
    """(counters, the work items they cover), or None."""
    if record["trace"] is None:
        return None
    c = snapshot()
    if c is None:
        return None
    name = record["window"].extra["work_span"]
    return c, sum(1 for n, _, _ in record["spans"] if n == name)


def ratio(record, num: str, den: str, scale: float = 1.0
          ) -> Optional[float]:
    """scale x counter `num` over counter `den`; None where `den` is 0."""
    got = counters_of(record)
    if got is None or not got[0].get(den):
        return None
    return scale * got[0][num] / got[0][den]


def per_item(record, key: str, scale: float = 1.0) -> Optional[float]:
    """scale x counter `key` a work item."""
    got = counters_of(record)
    if got is None or got[1] == 0 or key not in got[0]:
        return None
    return scale * got[0][key] / got[1]
