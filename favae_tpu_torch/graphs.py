"""A step run many times, on the card as one CUDA graph replayed.

`run_steps(step, n, device)` calls `step()` n times. The step keeps its
state in tensors that it updates in place and makes no host sync (no
`.item()`, no data-dependent shape), so that one capture serves every call.
On the CPU the calls run eagerly. On a CUDA device the first call runs
eagerly on a side stream: it is the warm-up (lazy set-up, cuBLAS workspaces
and the kernels' per-stream arrival counters happen outside any capture).
The step is then captured once on that stream and the graph replayed on the
current stream for the other n - 1 calls. A capture that fails raises: there
is no eager fallback on the card. `run_steps` returns the captured `Graph`,
which a caller may keep and `run` again for a later run of the same step
(a serving plan, `models/serving_plan.py`), with the graph of the set-up
such a run repeats first (`before`) captured beside it.

Kernel launch counts (`LAUNCHES` of the kernel modules) and the work
counters beside them (`work_counts`) are counted on the host where a
wrapper launches, so a capture would count once and a replay not at all:
the counts taken during the capture are undone and added again after each
replay, and stay the launches and the work that ran on the card.

`STATS` counts the graphs captured, their replays and the host seconds the
captures took. The warm-up, the capture and each replay (with its `after`)
are the spans `graphs.first`, `graphs.capture` and `graphs.replay`
(`profiling.span`), none of them inside the captured body. A replay has a
span of its own: one span over all of a request's replays made a
`torch.profiler` trace of the request take minutes to reduce on the card.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from favae_tpu_torch.profiling import span

STATS = {"captures": 0, "replays": 0, "capture_s": 0.0}


def launch_counts() -> List[Dict[str, int]]:
    """The `LAUNCHES` dicts of every module with a hand-written kernel."""
    from favae_tpu_torch.ops import (decode_step_kernel, ffn_int8, gn,
                                     int8_matmul, ln_fused, mqa_decode,
                                     rows_gemm, vq)
    return [vq.LAUNCHES, gn.LAUNCHES, ffn_int8.LAUNCHES,
            decode_step_kernel.LAUNCHES, int8_matmul.LAUNCHES,
            ln_fused.LAUNCHES, mqa_decode.LAUNCHES, rows_gemm.LAUNCHES]


def work_counts() -> Dict[str, Dict[str, float]]:
    """The work counters by group: `vq` (`ops.vq.WORK`), `decode_step`
    (`ops.decode_step_kernel.WORK`), `rows_gemm` (`ops.rows_gemm.WORK`),
    `ffn_int8` (`ops.ffn_int8.WORK`), `codec` (`models.blocks.STATS`)."""
    from favae_tpu_torch.models import blocks
    from favae_tpu_torch.ops import decode_step_kernel, ffn_int8, rows_gemm, vq
    return {"vq": vq.WORK, "decode_step": decode_step_kernel.WORK,
            "rows_gemm": rows_gemm.WORK, "ffn_int8": ffn_int8.WORK,
            "codec": blocks.STATS}


def _counted() -> List[Dict[str, float]]:
    return launch_counts() + list(work_counts().values())


def counts_of(capture: Callable[[], None]) -> List[Dict[str, float]]:
    """Call `capture()` (a CUDA-graph capture, which launches nothing) and
    undo the launches and the work it counted; returns them, to be added
    once a replay (`add_counts`)."""
    counts = _counted()
    before = [dict(c) for c in counts]
    capture()
    taken = [{k: c[k] - b[k] for k in c} for c, b in zip(counts, before)]
    for c, b in zip(counts, before):
        c.update(b)
    return taken


def add_counts(taken: List[Dict[str, float]]) -> None:
    for c, d in zip(_counted(), taken):
        for k, v in d.items():
            c[k] += v


class Graph:
    """A captured step and the launch and work counts of one replay; with
    `before`, the graph of what a later run sets up before its first call
    (`run_steps`' `before`)."""

    def __init__(self, graph: "torch.cuda.CUDAGraph",
                 per_replay: List[Dict[str, float]],
                 before: Optional["Graph"] = None):
        self.graph, self.per_replay, self.before = graph, per_replay, before

    def replay(self, calls: range,
               after: Optional[Callable[[int], None]] = None) -> None:
        """Replay the step once for each call i of `calls`, `after(i)` once
        it is queued."""
        for i in calls:
            with span("graphs.replay"):
                self.graph.replay()
                add_counts(self.per_replay)
                if after is not None:
                    after(i)
            STATS["replays"] += 1

    def run(self, n: int,
            after: Optional[Callable[[int], None]] = None) -> None:
        """A later run of n calls: `before`'s graph, where there is one,
        then the step's n times."""
        if self.before is not None:
            self.before.replay(range(1))
        self.replay(range(n), after)


def _capture(fn: Callable[[], None], side: "torch.cuda.Stream",
             generator: Optional[torch.Generator]) -> Graph:
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)

    def capture():
        with torch.cuda.graph(graph, stream=side):
            fn()

    return Graph(graph, counts_of(capture))


def run_steps(step: Callable[[], None], n: int, device: torch.device,
              generator: Optional[torch.Generator] = None,
              after: Optional[Callable[[int], None]] = None,
              before: Optional[Callable[[], None]] = None
              ) -> Optional[Graph]:
    """Call `step()` n times, `after(i)` once call i is queued. `generator`:
    a CUDA generator the step draws from, registered with the graph so that
    each replay draws anew from it (the default generator needs no
    registration). `before`, where given, is called before the first call:
    set-up that a later run repeats (and a repeat leaves as it was); on a
    card its graph is captured too, after the step's, and replayed before a
    later run's calls (`Graph.run`). Returns the graph captured (None on
    the CPU or for n 1)."""
    device = torch.device(device)
    if device.type != "cuda":
        if before is not None:
            before()
        for i in range(n):
            step()
            if after is not None:
                after(i)
        return None
    if generator is not None and generator.device.type != "cuda":
        raise ValueError(f"run_steps: a graph on {device} cannot draw from a "
                         f"generator on {generator.device}")
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    with span("graphs.first"):
        side.wait_stream(current)
        with torch.cuda.stream(side):
            if before is not None:
                before()
            step()
        current.wait_stream(side)
        if after is not None:
            after(0)
    if n == 1:
        return None
    t0 = time.perf_counter()
    with span("graphs.capture"):
        kept = _capture(step, side, generator)
        if before is not None:
            kept.before = _capture(before, side, None)
    STATS["captures"] += 1 if before is None else 2
    STATS["capture_s"] += time.perf_counter() - t0
    kept.replay(range(1, n), after)
    return kept
