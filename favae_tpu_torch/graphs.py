"""A step run many times, on the card as one CUDA graph replayed.

`run_steps(step, n, device)` calls `step()` n times. The step keeps its
state in tensors that it updates in place and makes no host sync (no
`.item()`, no data-dependent shape), so that one capture serves every call.
On the CPU the calls run eagerly. On a CUDA device the first call runs
eagerly on a side stream: it is the warm-up (lazy set-up, cuBLAS workspaces
and the kernels' per-stream arrival counters happen outside any capture).
The step is then captured once on that stream and the graph replayed on the
current stream for the other n - 1 calls. A capture that fails raises: there
is no eager fallback on the card.

Kernel launch counts (`LAUNCHES` of the kernel modules) are counted on the
host where a wrapper launches, so a capture would count once and a replay
not at all: the counts taken during the capture are undone and added again
after each replay, and stay the launches that ran on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch


def launch_counts() -> List[Dict[str, int]]:
    """The `LAUNCHES` dicts of every module with a hand-written kernel."""
    from favae_tpu_torch.ops import (decode_step_kernel, ffn_int8, gn,
                                     int8_matmul, vq)
    return [vq.LAUNCHES, gn.LAUNCHES, ffn_int8.LAUNCHES,
            decode_step_kernel.LAUNCHES, int8_matmul.LAUNCHES]


def counts_of(capture: Callable[[], None]) -> List[Dict[str, int]]:
    """Call `capture()` (a CUDA-graph capture, which launches nothing) and
    undo the launches it counted; returns them, to be added once a replay
    (`add_counts`)."""
    counts = launch_counts()
    before = [dict(c) for c in counts]
    capture()
    taken = [{k: c[k] - b[k] for k in c} for c, b in zip(counts, before)]
    for c, b in zip(counts, before):
        c.update(b)
    return taken


def add_counts(taken: List[Dict[str, int]]) -> None:
    for c, d in zip(launch_counts(), taken):
        for k, v in d.items():
            c[k] += v


def run_steps(step: Callable[[], None], n: int, device: torch.device,
              generator: Optional[torch.Generator] = None,
              after: Optional[Callable[[int], None]] = None) -> None:
    """Call `step()` n times, `after(i)` once call i is queued. `generator`:
    a CUDA generator the step draws from, registered with the graph so that
    each replay draws anew from it (the default generator needs no
    registration)."""
    device = torch.device(device)
    if device.type != "cuda":
        for i in range(n):
            step()
            if after is not None:
                after(i)
        return
    if generator is not None and generator.device.type != "cuda":
        raise ValueError(f"run_steps: a graph on {device} cannot draw from a "
                         f"generator on {generator.device}")
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        step()
    current.wait_stream(side)
    if after is not None:
        after(0)
    if n == 1:
        return
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)

    def capture():
        with torch.cuda.graph(graph, stream=side):
            step()

    per_replay = counts_of(capture)
    for i in range(1, n):
        graph.replay()
        add_counts(per_replay)
        if after is not None:
            after(i)
