"""Serving plans: the set-up of the CAT token loop that a request does not
change, kept with the `GPT` across requests.

`models/gpt.py`'s `sample_loop` keeps, in the GPT's store (`store(gpt)`,
an attribute of the module, so that it goes with it), the weights each
route prepares once (`Store.prepared`: the Dense casts of the exact and
FFN-only routes, `quantize_decode_params`' int8 FFN set,
`prepare_fused_decode`'s set) and up to `MAX_PLANS` plans (`Store.plan`),
one a key: the route, the
device, the GPT's dtype, the shape of the doubled context (its 2B rows)
and the sampler settings the token step bakes in (`top_k`, `top_p`,
`temperature`, `cond_scale`), as the JAX package's `CATModel` keeps one
jitted sampler for each (favae_tpu/models/txt_cond.py). A plan is the
loop's `TokenLoop`: its persistent inputs, the loop state, the step and,
on the card, the captured graph of the step; a later request with its key
copies its inputs in and replays the graph for every token.

The store is stamped with each parameter's and buffer's `_version` and
`data_ptr` and the links of the GPT's module tree. A call that finds
another stamp drops every plan and prepared weight before anything is
built again: an in-place update (an optimizer step, `load_state_dict`), a
move of the GPT, a module or parameter put in another's place. A fifth
key drops the plan used least recently. `drop(gpt)` frees them all.
`STATS` counts the plans built, the requests that found theirs (hits)
and the plans dropped.
"""

from __future__ import annotations

import collections
import itertools
import operator
from typing import Any, Callable, Hashable, List, Tuple

import torch
from torch import nn

STATS = {"plan_builds": 0, "plan_hits": 0, "plan_drops": 0}
MAX_PLANS = 4
_VERSION = operator.attrgetter("_version")
_DATA_PTR = operator.methodcaller("data_ptr")


class Store:
    """A GPT's prepared weights by name and its plans by key, the least
    recently used first, with the stamp of the parameters they came from.
    A copy of the GPT (`copy.deepcopy`, pickling) gets an empty store."""

    def __init__(self):
        self.stamp: Tuple = ()
        self.links: Tuple[Tuple, Tuple, Tuple] = ((), (), ())
        self.tensors: List[torch.Tensor] = []
        self.versioned: List[torch.Tensor] = []
        self.weights: dict = {}
        self.plans: collections.OrderedDict = collections.OrderedDict()

    def __deepcopy__(self, memo):
        return Store()

    def __reduce__(self):
        return (Store, ())

    def clear(self) -> None:
        STATS["plan_drops"] += len(self.plans)
        self.plans.clear()
        self.weights.clear()
        self.stamp, self.links = (), ((), (), ())
        self.tensors, self.versioned = [], []

    def stale(self) -> bool:
        """Whether the GPT changed since the stamp: a module, parameter or
        buffer put in another's place (each link of the module tree is
        checked by identity), or a parameter or buffer updated in place or
        moved (`_version`, `data_ptr`). The checks cost about a fifteenth
        of walking the tree anew (`restamp`), which is host time of each
        request's first token."""
        dicts, keys, values = self.links
        return not (dicts
                    and all(map(operator.is_, map(dict.get, dicts, keys),
                                values))
                    and self._stamp() == self.stamp)

    def restamp(self, gpt: nn.Module) -> None:
        """Stamp the GPT as it is now."""
        links = [(d, k, v) for m in gpt.modules()
                 for d in (m._modules, m._parameters, m._buffers)
                 for k, v in d.items() if v is not None]
        self.links = tuple(zip(*links)) if links else ((), (), ())
        self.tensors = list(itertools.chain(gpt.parameters(), gpt.buffers()))
        self.versioned = [t for t in self.tensors if not t.is_inference()]
        self.stamp = self._stamp()

    def _stamp(self) -> Tuple:
        """(`_version` of each parameter and buffer but those made in
        inference mode, which keep none; `data_ptr` of each)."""
        return (tuple(map(_VERSION, self.versioned)),
                tuple(map(_DATA_PTR, self.tensors)))

    def prepared(self, name: str, make: Callable[[], Any]) -> Any:
        """The prepared weights `name`, made by `make()` the first time."""
        if name not in self.weights:
            self.weights[name] = make()
        return self.weights[name]

    def owns(self, prepared: Any) -> bool:
        """Whether `prepared` is prepared weights this store holds, and
        not a caller's own or a stale set."""
        return any(w is prepared for w in self.weights.values())

    def plan(self, key: Hashable, build: Callable[[], Any]
             ) -> Tuple[Any, bool]:
        """(the plan of `key`, whether it was kept): the one kept for it,
        or `build()`, kept after dropping the least recently used where
        `MAX_PLANS` are kept."""
        got = self.plans.get(key)
        if got is not None:
            self.plans.move_to_end(key)
            STATS["plan_hits"] += 1
            return got, True
        while len(self.plans) >= MAX_PLANS:
            self.plans.popitem(last=False)
            STATS["plan_drops"] += 1
        got = self.plans[key] = build()
        STATS["plan_builds"] += 1
        return got, False


def store(gpt: nn.Module) -> Store:
    """The GPT's store, emptied first where the GPT changed since it was
    stamped (`Store.stale`)."""
    got = gpt.__dict__.get("_serving_plans")
    if got is None:
        got = gpt._serving_plans = Store()
    if got.stale():
        got.clear()
        got.restamp(gpt)
    return got


def weights(gpt: nn.Module, name: str, make: Callable[[], Any]) -> Any:
    """The GPT's prepared weights `name`, made by `make()` the first time
    after each change of its parameters."""
    return store(gpt).prepared(name, make)


def drop(gpt: nn.Module) -> None:
    """Free the GPT's plans and prepared weights."""
    got = gpt.__dict__.get("_serving_plans")
    if got is not None:
        got.clear()
