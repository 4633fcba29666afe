"""Exponential moving average of parameters (JAX ``models/ema.py``,
ema_pytorch's semantics as the reference's standalone trainer uses them).

The update counts steps; it fires every ``update_every``-th step, and then
copies the parameters while the step is at most ``update_after_step`` and
blends ``e * decay + p * (1 - decay)`` after.  :class:`EmaState` holds the
averaged tensors (for instance the parameters of a copy of the model, which
then samples with the average) and the step; :func:`ema_update` updates them
in place, outside autograd, and returns the state."""

from __future__ import annotations

from typing import Mapping

import torch


class EmaState:
    """``params``: name -> averaged tensor; ``step``: updates counted."""

    def __init__(self, params: Mapping[str, torch.Tensor], step: int = 0):
        self.params = dict(params)
        self.step = int(step)

    @classmethod
    def create(cls, params: Mapping[str, torch.Tensor]) -> "EmaState":
        """A state starting from a detached copy of ``params``."""
        return cls({k: v.detach().clone() for k, v in params.items()})

    def state_dict(self) -> dict:
        return {"params": {k: v.detach().cpu() for k, v in self.params.items()},
                "step": self.step}


@torch.no_grad()
def ema_update(ema: EmaState, params: Mapping[str, torch.Tensor], decay: float = 0.995,
               update_every: int = 10, update_after_step: int = 100) -> EmaState:
    """One step of the average over ``params`` (the same names as
    ``ema.params``)."""
    ema.step += 1
    if ema.step % update_every != 0:
        return ema
    keys = list(ema.params)
    e = [ema.params[k] for k in keys]
    p = [params[k].detach() for k in keys]
    if ema.step > update_after_step:
        p = torch._foreach_add(torch._foreach_mul(e, decay), torch._foreach_mul(p, 1.0 - decay))
    for a, b in zip(e, p):
        a.copy_(b)
    return ema


__all__ = ["EmaState", "ema_update"]
