"""Frozen copy of the port's `train/adam.py` with its plain paths only, the
benchmark's reference (imports nothing of the port; see ../README.md).

Adam as optax computes it, with storage dtypes for its moments.

`OptaxAdam` is one hand-written update over lists of tensors
(`torch._foreach_*`): the moments update in f32 from their stored values
(b * m in the storage dtype, as optax's weakly typed product), the bias
correction reads the f32 moments before they are cast to their storage
dtypes (optax's `mu_dtype`; `nu_dtype` for the CAT trainer), and the cast
happens once at the end; with f32 moments and no weight decay it is
`optax.adam` (and `torch.optim.Adam`), with weight decay `optax.adamw`:
p <- p - lr (m^/(sqrt(v^) + eps) + wd p). A parameter without a gradient
takes a zero one, as optax's chain sees it. Used by `CATAdamW` and by the
FA-VAE optimizers with `adam_mu_dtype="bfloat16"`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


class OptaxAdam:
    """Adam over `params` with b1, b2, eps, weight decay on the parameters
    at the indices `decayed`, and storage dtypes for the two moments.
    `step(lr)` applies one update from the parameters' `.grad`."""

    def __init__(self, params: Sequence[torch.Tensor], b1: float, b2: float,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 decayed: Sequence[int] = (),
                 mu_dtype: torch.dtype = torch.float32,
                 nu_dtype: torch.dtype = torch.float32):
        self.params = list(params)
        self.decayed = list(decayed)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype, self.nu_dtype = mu_dtype, nu_dtype
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=nu_dtype) for p in self.params]
        self.count = 0

    @staticmethod
    def _decayed(store: List[torch.Tensor], b: float) -> List[torch.Tensor]:
        if store[0].dtype == torch.float32:
            torch._foreach_mul_(store, b)
            return store
        b = float(torch.tensor(b, dtype=store[0].dtype))
        return [m.float() for m in torch._foreach_mul(store, b)]

    @torch.no_grad()
    def step(self, lr: float) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        self.count += 1
        # (1 - b) g + b m and (1 - b) g^2 + b v (optax's update_moment): b m
        # in the storage dtype with b rounded to it, as optax's weakly typed
        # product is, and the sum in f32; in place where the store is f32
        mu = self._decayed(self.mu, self.b1)
        nu = self._decayed(self.nu, self.b2)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        # bias corrections as optax forms them: f32 powers of f32 decays
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.int32(self.count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.int32(self.count))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        if self.weight_decay and self.decayed:
            torch._foreach_add_([upd[i] for i in self.decayed],
                                [self.params[i] for i in self.decayed],
                                alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        if mu is not self.mu:
            torch._foreach_copy_(self.mu, mu)
        if nu is not self.nu:
            torch._foreach_copy_(self.nu, nu)

    def state_dict(self) -> Dict:
        """The moments in their storage dtypes and the update count (what
        optax's state holds), as lists in the parameters' order."""
        return {"mu": list(self.mu), "nu": list(self.nu),
                "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        """Copy a `state_dict` of an optimizer over the same parameters and
        moment dtypes into this one."""
        for name in ("mu", "nu"):
            ours, theirs = getattr(self, name), sd[name]
            if len(theirs) != len(ours) or any(
                    a.shape != b.shape or a.dtype != b.dtype
                    for a, b in zip(ours, theirs)):
                raise ValueError(
                    f"the checkpoint's {name} does not match this "
                    f"optimizer's parameters and {name} dtype "
                    f"({ours[0].dtype})")
            torch._foreach_copy_(ours, list(theirs))
        self.count = int(sd["count"])
