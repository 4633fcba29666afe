"""The optimizer and the train step on one device (JAX ``parallel/train.py``).

JAX builds one jitted step over a device mesh; here the step is eager
PyTorch on one device (data parallelism across cards is later work).  The
optimizer is the reference's Lightning setup: global-norm gradient clipping
(``gradient_clip_val``), then ``torch.optim.Adam(weight_decay=...)``, which
adds the decay to the gradient before the moments (L2, not AdamW), as
optax's ``clip_by_global_norm -> add_decayed_weights -> adam`` chain does.
``decoupled=True`` is optax's ``clip_by_global_norm -> adamw`` instead
(``torch.optim.AdamW``: the decay scales the parameters, outside the
moments), which RAFT's flow pretraining uses.  ``betas`` are Adam's (the
standalone trainer's (0.9, 0.99); optax's defaults otherwise).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from ..utils.grad_stats import grad_norm_stats


class Optimizer:
    """Global-norm clip (optional) followed by Adam with L2 weight decay, or
    with decoupled weight decay (AdamW) when ``decoupled``."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 weight_decay: float = 0.0, clip: Optional[float] = None,
                 decoupled: bool = False, betas: Tuple[float, float] = (0.9, 0.999)):
        self.params = [p for p in params if p.requires_grad]
        self.clip = None if clip is None else float(clip)
        adam = torch.optim.AdamW if decoupled else torch.optim.Adam
        self.adam = adam(self.params, lr=float(lr), betas=tuple(betas), eps=1e-8,
                         weight_decay=float(weight_decay))

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def clip_grads(self) -> None:
        """Scale all gradients by clip / ||g|| when the global norm ||g||
        reaches ``clip`` (optax ``clip_by_global_norm``), without a host sync."""
        if self.clip is None:
            return
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([g.float().norm() for g in grads]))
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        torch._foreach_mul_(grads, scale)

    def step(self) -> None:
        self.clip_grads()
        self.adam.step()

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


def make_optimizer(params, lr: float, weight_decay: float = 0.0,
                   clip: Optional[float] = None, decoupled: bool = False,
                   betas: Tuple[float, float] = (0.9, 0.999)) -> Optimizer:
    return Optimizer(params, lr, weight_decay, clip, decoupled, betas)


class TrainState:
    """The step count, the module and its optimizer."""

    def __init__(self, module: torch.nn.Module, optimizer: Optimizer, step: int = 0):
        self.module = module
        self.optimizer = optimizer
        self.step = int(step)


LossFn = Callable[[tuple, torch.Generator], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_train_step(loss_fn: LossFn, accumulate: int = 1, with_grad_stats: bool = False):
    """``step(state, batch, generator) -> metrics``: the loss and gradients
    of ``loss_fn(batch, generator)`` (averaged over ``accumulate``
    microbatches, split along the batch), one optimizer step, and the
    metrics (``train/loss``; with ``with_grad_stats`` the gradient-norm
    statistics of the unclipped gradients).  Metrics stay on the device."""

    def step(state: TrainState, batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        opt = state.optimizer
        opt.zero_grad()
        micro = [batch] if accumulate <= 1 else list(zip(
            *(t.chunk(accumulate, dim=0) for t in batch)))
        loss_sum, metrics = None, {}
        for mb in micro:
            loss, m = loss_fn(tuple(mb), generator)
            (loss / len(micro)).backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach() / len(micro)
        metrics["train/loss"] = loss_sum / len(micro)
        if with_grad_stats:
            live = [p for p in opt.params if p.grad is not None]
            metrics.update(grad_norm_stats([p.grad for p in live], live))
        opt.step()
        state.step += 1
        return metrics

    return step


__all__ = ["LossFn", "Optimizer", "TrainState", "make_optimizer", "make_train_step"]
