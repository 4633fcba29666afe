"""Conditional DDPM/DDIM sampling (JAX ``models/diffusion.py``).

The schedule tables are computed in float64 with numpy and kept as float32
tensors.  The model is a closure ``model_fn(x, cond, t) -> out`` on NCHW
tensors.  The samplers are Python loops (JAX scans them); each draws its
initial noise and per-step noise from a ``torch.Generator`` unless the caller
passes them (``x_T``, ``noises``), which is how the tests feed both
frameworks the same random numbers.

Ported for the serving path: the three beta schedules, ``make_schedule``,
``extract``, the ``predict_*`` functions, ``q_posterior``,
``model_predictions``, ``p_sample_loop``, ``ddim_sample``, ``dpmpp_sample``
and ``sample`` with ``noise_space='image'``.  The flow-noise forward process
is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

ModelFn = Callable[..., torch.Tensor]


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    ac = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    return np.clip(1 - (ac[1:] / ac[:-1]), 0, 0.999)


def sigmoid_beta_schedule(timesteps: int, start: float = -3, end: float = 3,
                          tau: float = 1) -> np.ndarray:
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    v_start, v_end = sig(start / tau), sig(end / tau)
    ac = (-sig((t * (end - start) + start) / tau) + v_end) / (v_end - v_start)
    ac = ac / ac[0]
    return np.clip(1 - (ac[1:] / ac[:-1]), 0, 0.999)


_SCHEDULES = {
    "linear": linear_beta_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Diffusion schedule tables (float32 tensors on one device)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    loss_weight: torch.Tensor
    num_timesteps: int = 1000
    sampling_timesteps: int = 1000
    objective: str = "pred_x0"
    ddim_sampling_eta: float = 0.0
    noise_space: str = "image"
    sampler: str = "auto"

    @property
    def is_ddim_sampling(self) -> bool:
        return self.sampling_timesteps < self.num_timesteps


def make_schedule(
    timesteps: int = 1000,
    sampling_timesteps: Optional[int] = None,
    objective: str = "pred_x0",
    beta_schedule: str = "sigmoid",
    ddim_sampling_eta: float = 0.0,
    min_snr_loss_weight: bool = False,
    min_snr_gamma: float = 5.0,
    noise_space: str = "image",
    sampler: str = "auto",
    device="cuda",
) -> Schedule:
    if objective not in ("pred_noise", "pred_x0", "pred_v"):
        raise ValueError(f"unknown objective {objective!r}")
    if sampler not in ("auto", "ancestral", "ddim", "dpmpp"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if sampler == "dpmpp" and noise_space != "image":
        raise NotImplementedError(
            "sampler='dpmpp' integrates the additive-noise probability-flow ODE; "
            "the permutation-warp forward process (noise_space='flow') has no "
            "such ODE: use the ancestral sampler"
        )
    if sampler == "dpmpp" and int(sampling_timesteps or timesteps) < 2:
        raise ValueError(
            "sampler='dpmpp' requires sampling_timesteps >= 2 "
            "(use sampler='ddim' for single-step sampling)"
        )
    if noise_space != "image":
        raise NotImplementedError("noise_space='flow' is not ported yet")
    betas = _SCHEDULES[beta_schedule](timesteps)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.concatenate([np.ones((1,), ac.dtype), ac[:-1]])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    snr = ac / (1 - ac)
    clipped = np.minimum(snr, min_snr_gamma) if min_snr_loss_weight else snr
    if objective == "pred_noise":
        loss_weight = clipped / snr
    elif objective == "pred_x0":
        loss_weight = clipped
    else:
        loss_weight = clipped / (snr + 1)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Schedule(
        betas=f32(betas),
        alphas_cumprod=f32(ac),
        alphas_cumprod_prev=f32(ac_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(ac)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - ac)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1)),
        posterior_variance=f32(post_var),
        posterior_log_variance_clipped=f32(np.log(np.clip(post_var, 1e-20, None))),
        posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
        posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac)),
        loss_weight=f32(loss_weight),
        num_timesteps=int(timesteps),
        sampling_timesteps=int(sampling_timesteps or timesteps),
        objective=objective,
        ddim_sampling_eta=float(ddim_sampling_eta),
        noise_space=noise_space,
        sampler=sampler,
    )


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    out = a[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def predict_start_from_noise(sched, x_t, t, noise):
    nd = x_t.dim()
    return (extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * noise)


def predict_noise_from_start(sched, x_t, t, x0):
    nd = x_t.dim()
    return ((extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0)
            / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd))


def predict_v(sched, x_start, t, noise):
    nd = x_start.dim()
    return (extract(sched.sqrt_alphas_cumprod, t, nd) * noise
            - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * x_start)


def predict_start_from_v(sched, x_t, t, v):
    nd = x_t.dim()
    return (extract(sched.sqrt_alphas_cumprod, t, nd) * x_t
            - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * v)


def q_posterior(sched, x_start, x_t, t):
    nd = x_t.dim()
    mean = (extract(sched.posterior_mean_coef1, t, nd) * x_start
            + extract(sched.posterior_mean_coef2, t, nd) * x_t)
    return (mean, extract(sched.posterior_variance, t, nd),
            extract(sched.posterior_log_variance_clipped, t, nd))


def model_predictions(sched: Schedule, model_fn: ModelFn, x, t,
                      clip_x_start: bool = False, rederive_pred_noise: bool = False,
                      external_cond=None):
    """(pred_noise, pred_x_start)."""
    out = model_fn(x, external_cond, t)
    clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_x_start else (lambda v: v)
    if sched.objective == "pred_noise":
        pred_noise = out
        x_start = clip(predict_start_from_noise(sched, x, t, pred_noise))
        if clip_x_start and rederive_pred_noise:
            pred_noise = predict_noise_from_start(sched, x, t, x_start)
    elif sched.objective == "pred_x0":
        x_start = clip(out)
        pred_noise = predict_noise_from_start(sched, x, t, x_start)
    else:
        x_start = clip(predict_start_from_v(sched, x, t, out))
        pred_noise = predict_noise_from_start(sched, x, t, x_start)
    return pred_noise, x_start


def _randn(shape, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def p_sample_loop(sched: Schedule, model_fn: ModelFn, shape: Sequence[int],
                  external_cond=None, generator: Optional[torch.Generator] = None,
                  x_T=None, noises: Optional[Sequence[torch.Tensor]] = None,
                  return_every: Optional[int] = None, device="cuda"):
    """Ancestral sampling over all T steps.

    Returns the final state, or with ``return_every=k`` a trajectory
    (B, T//k + 1, ...) holding x_T and the state after every k steps.
    ``noises[i]`` is the noise of the i-th step (t = T-1-i)."""
    T = sched.num_timesteps
    img = _randn(shape, generator, device) if x_T is None else x_T.float()
    traj: List[torch.Tensor] = [img]
    if return_every is not None and T % int(return_every):
        raise ValueError("return_every must divide num_timesteps")
    for i, t in enumerate(range(T - 1, -1, -1)):
        bt = torch.full((shape[0],), t, dtype=torch.long, device=img.device)
        _, x_start = model_predictions(sched, model_fn, img, bt,
                                       external_cond=external_cond)
        x_start = x_start.clamp(-1.0, 1.0)
        mean, _, log_var = q_posterior(sched, x_start, img, bt)
        if t > 0:
            noise = _randn(shape, generator, device) if noises is None else noises[i]
            img = mean + torch.exp(0.5 * log_var) * noise
        else:
            img = mean
        if return_every is not None and (i + 1) % int(return_every) == 0:
            traj.append(img)
    if return_every is None:
        return img
    return torch.stack(traj, dim=1)


def linspace_int(start: float, stop: float, num: int) -> List[int]:
    """``jnp.linspace(start, stop, num).astype(jnp.int32)`` as the JAX
    package computes it, bit for bit.  XLA evaluates the linspace in float32
    as ``r = 1/div``, ``c = stop*r``, ``a = start*(1 - i*r)`` and
    ``a + i*c`` with one rounding (a fused multiply-add), ends on ``stop``
    exactly, and the cast truncates towards zero.  Where a point is an exact
    integer in real arithmetic it can land one ulp low and truncate to the
    integer below (T=1000: S=55 gives 198 where ``1000*11/55 - 1`` is 199),
    so the exact-integer formula is not the JAX grid."""
    f32 = np.float32
    if num == 1:
        return [int(np.trunc(f32(start)))]
    div = num - 1
    i = np.arange(div, dtype=np.float32)
    r = f32(1.0) / f32(div)
    c = f32(f32(stop) * r)
    a = f32(start) * (f32(1.0) - i * r)
    # i*c is exact in float64 and the sum is rounded to float32 once
    out = (a.astype(np.float64) + i.astype(np.float64) * np.float64(c)).astype(np.float32)
    out = np.append(out, f32(stop))
    return [int(v) for v in np.trunc(out)]


def ddim_sample(sched: Schedule, model_fn: ModelFn, shape: Sequence[int],
                external_cond=None, generator: Optional[torch.Generator] = None,
                x_T=None, noises: Optional[Sequence[torch.Tensor]] = None,
                return_every: Optional[int] = None, device="cuda"):
    """DDIM over ``sched.sampling_timesteps`` steps.  With eta = 0 (the
    flagship) no noise is drawn.  ``return_every=k`` returns (B, K, ...)
    with x_T, every k-th state and always the final one."""
    T, S, eta = sched.num_timesteps, sched.sampling_timesteps, sched.ddim_sampling_eta
    times = linspace_int(-1, T - 1, S + 1)[::-1]
    img = _randn(shape, generator, device) if x_T is None else x_T.float()
    traj: List[torch.Tensor] = [img]
    ac = sched.alphas_cumprod
    one = torch.ones((), device=img.device)
    for i, (t, t_next) in enumerate(zip(times[:-1], times[1:])):
        bt = torch.full((shape[0],), t, dtype=torch.long, device=img.device)
        pred_noise, x_start = model_predictions(
            sched, model_fn, img, bt, clip_x_start=True, rederive_pred_noise=True,
            external_cond=external_cond,
        )
        if t_next < 0:
            img = x_start
        else:
            alpha, alpha_next = ac[t], ac[t_next]
            sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
            c = torch.sqrt(torch.clamp(one - alpha_next - sigma ** 2, min=0.0))
            img = x_start * torch.sqrt(alpha_next) + c * pred_noise
            if eta != 0:
                noise = _randn(shape, generator, device) if noises is None else noises[i]
                img = img + sigma * noise
        traj.append(img)
    if return_every is None:
        return img
    idx = list(range(0, S + 1, max(1, int(return_every))))
    if idx[-1] != S:
        idx.append(S)
    return torch.stack([traj[k] for k in idx], dim=1)


def dpmpp_sample(sched: Schedule, model_fn: ModelFn, shape: Sequence[int],
                 external_cond=None, generator: Optional[torch.Generator] = None,
                 x_T=None, noises=None, return_every: Optional[int] = None,
                 device="cuda"):
    """DPM-Solver++(2M) over ``sched.sampling_timesteps`` model calls (JAX
    ``dpmpp_sample``): a second-order multistep integrator of the
    probability-flow ODE in data-prediction space on the trailing grid
    ``linspace(0, T-1, S)`` (last call at t = 0), first order on the first
    and the final step; the final state is the last x0.  Deterministic: only
    x_T is drawn (``noises`` is ignored).  The step coefficients are float32
    scalars computed on the host from the schedule, as JAX computes them in
    float32.  ``return_every=k`` returns (B, K, ...) as ``ddim_sample``."""
    del noises
    T, S = sched.num_timesteps, sched.sampling_timesteps
    times = linspace_int(0, T - 1, S)[::-1] + [-1]
    img = _randn(shape, generator, device) if x_T is None else x_T.float()
    traj: List[torch.Tensor] = [img]
    ac = sched.alphas_cumprod.detach().cpu()

    def lam(t):
        a = ac[t]
        return 0.5 * (torch.log(a) - torch.log1p(-a))

    prev_x0, prev_lam = None, None
    for t, t_next in zip(times[:-1], times[1:]):
        bt = torch.full((shape[0],), t, dtype=torch.long, device=img.device)
        _, x0 = model_predictions(sched, model_fn, img, bt, clip_x_start=True,
                                  external_cond=external_cond)
        lam_t = lam(t)
        if t_next < 0:
            img = x0
        else:
            h = lam(t_next) - lam_t
            alpha_next = torch.sqrt(ac[t_next])
            sigma_t = torch.sqrt(1.0 - ac[t])
            sigma_next = torch.sqrt(1.0 - ac[t_next])
            d = x0
            if prev_x0 is not None:
                # 2M correction: D = x0 + (x0 - prev_x0) / (2 r), r = h_prev / h
                r = (lam_t - prev_lam) / torch.where(h == 0, torch.ones_like(h), h)
                d = x0 + (x0 - prev_x0) / float(torch.clamp(2.0 * r, min=1e-6))
            img = (float(sigma_next / sigma_t) * img
                   - float(alpha_next * torch.expm1(-h)) * d)
        prev_x0, prev_lam = x0, lam_t
        traj.append(img)
    if return_every is None:
        return img
    idx = list(range(0, S + 1, max(1, int(return_every))))
    if idx[-1] != S:
        idx.append(S)
    return torch.stack([traj[k] for k in idx], dim=1)


def sample(sched: Schedule, model_fn: ModelFn, shape: Sequence[int], external_cond=None,
           generator: Optional[torch.Generator] = None, x_T=None, noises=None,
           return_every: Optional[int] = None, device="cuda"):
    """DPM-Solver++(2M) for ``sampler='dpmpp'``; DDIM when
    ``sampling_timesteps < T`` (or ``sampler='ddim'``); the ancestral loop
    otherwise."""
    if sched.sampler == "dpmpp":
        fn = dpmpp_sample
    elif sched.sampler == "ddim" or (sched.sampler == "auto" and sched.is_ddim_sampling):
        fn = ddim_sample
    else:
        fn = p_sample_loop
    return fn(sched, model_fn, shape, external_cond, generator, x_T, noises,
              return_every, device)


__all__ = [
    "Schedule", "make_schedule", "extract", "model_predictions", "q_posterior",
    "predict_start_from_noise", "predict_noise_from_start", "predict_v",
    "predict_start_from_v", "p_sample_loop", "ddim_sample", "dpmpp_sample",
    "linspace_int", "sample",
]
