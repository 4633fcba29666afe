"""Conditional DDPM/DDIM sampling (JAX ``models/diffusion.py``).

The schedule tables are computed in float64 with numpy and kept as float32
tensors.  The model is a closure ``model_fn(x, cond, t) -> out`` on NCHW
tensors.  The samplers are Python loops (JAX scans them); each draws its
initial noise and per-step noise from a ``torch.Generator`` unless the caller
passes them (``x_T``, ``noises``), which is how the tests feed both
frameworks the same random numbers.

Ported: the three beta schedules, ``make_schedule``, ``extract``, the
``predict_*`` functions, ``q_posterior``, ``model_predictions``, the
training losses ``q_sample``, ``pyramid_loss`` and ``p_losses`` (with an
extra target such as the ``target`` target's flow head, self-conditioning
and offset noise), the samplers ``p_sample_loop``, ``ddim_sample``,
``dpmpp_sample`` and ``sample`` (each strips and returns the model's extra
output channels with ``additional_channels``), and ``interpolate``.

``noise_space='flow'`` is JAX's permutation-warp forward process: x_0 is
permute-warped (``ops/warp.py::permute_warp``) by a Gaussian flow whose
scale in pixels is the additive process's noise-to-signal ratio
sqrt(1 - a_t) / sqrt(a_t) (``_flow_sigma``), so the noise is (B, 2, H, W);
the ancestral sampler perturbs the posterior mean the same way.  It needs
``objective='pred_x0'`` and has no DPM++ (both raise, as in JAX).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.warp import nan_mse_stats, permute_warp

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
    if noise_space not in ("image", "flow"):
        raise ValueError(f"unknown noise_space {noise_space!r}")
    if noise_space == "flow" and objective != "pred_x0":
        raise NotImplementedError(
            "noise_space='flow' requires objective='pred_x0': the flow-noise forward "
            "process has no epsilon/v target"
        )
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
                      external_cond=None, x_self_cond=None, additional_channels: int = 0):
    """(pred_noise, pred_x_start); with ``additional_channels`` the model's
    last channels are split off and returned third.  ``x_self_cond`` goes to
    the model as its fourth argument when given."""
    out = (model_fn(x, external_cond, t) if x_self_cond is None
           else model_fn(x, external_cond, t, x_self_cond))
    additional = None
    if additional_channels:
        additional = out[:, -additional_channels:]
        out = out[:, :-additional_channels]
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
    if additional_channels:
        return pred_noise, x_start, additional
    return pred_noise, x_start


def noise_shape(sched: Schedule, shape: Sequence[int]) -> Tuple[int, ...]:
    """The forward-process noise of a state of ``shape`` (B, C, H, W): a
    flow (B, 2, H, W) under flow noise, else the state's shape."""
    if sched.noise_space == "flow":
        return (shape[0], 2) + tuple(shape[2:])
    return tuple(shape)


def _flow_sigma(sched: Schedule, t, x):
    """The flow noise's scale (B, 2, 1, 1) for ``permute_warp``'s
    normalised units (1.0 = the full extent), x then y: the noise-to-signal
    ratio sqrt(1 - a_t) / sqrt(a_t) in pixels over W and H."""
    H, W = x.shape[2], x.shape[3]
    nsr = extract(sched.sqrt_one_minus_alphas_cumprod
                  / torch.clamp(sched.sqrt_alphas_cumprod, min=1e-6), t, x.dim())
    per_axis = torch.tensor([1.0 / W, 1.0 / H], dtype=torch.float32, device=nsr.device)
    return nsr * per_axis.view(1, 2, 1, 1)


def q_sample(sched: Schedule, x_start, t, noise):
    """The forward process: x_t = sqrt(a_t) x_0 + sqrt(1 - a_t) noise, or
    under flow noise x_0 permute-warped by ``_flow_sigma * noise`` (noise
    (B, 2, H, W))."""
    if sched.noise_space == "flow":
        return permute_warp(x_start, _flow_sigma(sched, t, x_start) * noise)
    nd = x_start.dim()
    return (extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def pyramid_loss(image_out, target, flow_tgt=None, external_cond=None, flow_out=None,
                 warp_fn: Optional[Callable] = None, levels: Tuple[int, ...] = (1, 2, 4, 8, 16),
                 flow_loss_weight: float = 0.0):
    """The reference ``_loss``: a NaN-aware MSE of the image at level 1 and,
    with a flow target, at every other level the model-flow warp of the
    conditioning against the target splatted by a zero flow (both at
    ``scale=level``), scaled by ``level**4``; one mean over the (sum, count)
    pairs of all terms."""
    total_sum, total_cnt = nan_mse_stats(image_out, target)
    if flow_tgt is not None:
        for level in levels:
            if level == 1:
                continue
            warped = warp_fn(external_cond, flow_out, scale=level)
            tgt_ds = warp_fn(target, torch.zeros_like(flow_out), scale=level)
            s, n = nan_mse_stats(warped, tgt_ds)
            total_sum = total_sum + s * (level ** 4)
            total_cnt = total_cnt + n
        if flow_loss_weight > 0.0 and flow_out is not None:
            s, n = nan_mse_stats(flow_out, flow_tgt)
            total_sum = total_sum + s * flow_loss_weight
            total_cnt = total_cnt + n
    return total_sum / torch.clamp(total_cnt, min=1)


def p_losses(sched: Schedule, model_fn: ModelFn, x_start, t, noise, external_cond=None,
             warp_fn: Optional[Callable] = None, image_channels: int = 3,
             model_out_override=None, flow_loss_weight: float = 0.0, additional_tgt=None,
             self_condition: bool = False, offset_noise_strength: float = 0.0,
             generator: Optional[torch.Generator] = None, self_cond_coin=None,
             offset_noise=None):
    """The training loss of one batch at timesteps ``t`` (B,) with the
    forward-process ``noise`` (the caller draws both; JAX draws them from
    its key unless given).  For the joint target (image + flow channels) the
    pyramid loss of the image and the flow; with ``additional_tgt`` (B, k,
    H, W) the model's last k channels are its prediction (the ``target``
    target's flow head) and enter the pyramid loss as the flow.
    ``model_out_override`` replaces the model's output (the validation's
    ideal loss): a tensor, or a pair (output, extra channels).  With
    ``self_condition`` a fair coin (``self_cond_coin``, else drawn from
    ``generator``) feeds the model its own detached x_0 prediction, else
    zeros; ``offset_noise_strength`` adds that multiple of a per-(batch,
    channel) normal draw (``offset_noise``, (B, C, 1, 1), else drawn from
    ``generator``) to the noise."""
    dev = generator.device if generator is not None else x_start.device
    if offset_noise_strength > 0.0:
        if offset_noise is None:
            offset_noise = torch.randn(x_start.shape[:2] + (1, 1), generator=generator,
                                       device=dev)
        noise = noise + offset_noise_strength * offset_noise.to(noise.device)
    x = q_sample(sched, x_start, t, noise)
    x_self_cond = None
    if self_condition:
        if self_cond_coin is None:
            self_cond_coin = bool(torch.rand((), generator=generator, device=dev) < 0.5)
        if self_cond_coin:
            with torch.no_grad():
                x_self_cond = model_predictions(sched, model_fn, x, t,
                                                external_cond=external_cond)[1].detach()
        else:
            x_self_cond = torch.zeros_like(x)
    additional_out = None
    if model_out_override is not None:
        model_out = model_out_override
        if isinstance(model_out, tuple):
            model_out, additional_out = model_out
    else:
        model_out = (model_fn(x, external_cond, t) if x_self_cond is None
                     else model_fn(x, external_cond, t, x_self_cond))
        if additional_tgt is not None:
            k = additional_tgt.shape[1]
            additional_out = model_out[:, -k:]
            model_out = model_out[:, :-k]
    if sched.objective == "pred_noise":
        target = noise
    elif sched.objective == "pred_x0":
        target = x_start
    else:
        target = predict_v(sched, x_start, t, noise)
    if additional_tgt is not None:
        return pyramid_loss(model_out, target, additional_tgt, external_cond, additional_out,
                            warp_fn, flow_loss_weight=flow_loss_weight)
    if target.shape[1] == image_channels + 2:      # joint target (image + flow)
        c = image_channels
        return pyramid_loss(model_out[:, :c], target[:, :c], target[:, c:], external_cond,
                            model_out[:, c:], warp_fn, flow_loss_weight=flow_loss_weight)
    return pyramid_loss(model_out, target)


def _randn(shape, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def _ancestral_step(sched: Schedule, mean, log_var, t: int, noise):
    """x_{t-1} from the posterior mean: plus sigma * noise, or under flow
    noise the mean permute-warped by sigma * noise (B, 2, H, W); the mean
    itself at t = 0 (``noise`` None)."""
    if t == 0:
        return mean
    if sched.noise_space == "flow":
        return permute_warp(mean, torch.exp(0.5 * log_var) * noise)
    return mean + torch.exp(0.5 * log_var) * noise


def _strided(traj: List[torch.Tensor], adds: List[torch.Tensor], S: int, return_every: int):
    """A DDIM/DPM++ trajectory (B, K, ...) of x_T, every k-th state and
    always the final one, and the extra channels of the same steps (the
    first step's beside x_T)."""
    idx = list(range(0, S + 1, max(1, int(return_every))))
    if idx[-1] != S:
        idx.append(S)
    out = torch.stack([traj[k] for k in idx], dim=1)
    if not adds:
        return out
    return out, torch.stack([adds[max(k - 1, 0)] for k in idx], dim=1)


def p_sample_loop(sched: Schedule, model_fn: ModelFn, shape: Sequence[int],
                  external_cond=None, generator: Optional[torch.Generator] = None,
                  x_T=None, noises: Optional[Sequence[torch.Tensor]] = None,
                  return_every: Optional[int] = None, device="cuda",
                  additional_channels: int = 0):
    """Ancestral sampling over all T steps.

    Returns the final state, or with ``return_every=k`` a trajectory
    (B, T//k + 1, ...) holding x_T and the state after every k steps.
    ``noises[i]`` is the noise of the i-th step (t = T-1-i): the state's
    shape, or (B, 2, H, W) under flow noise.  With ``additional_channels``
    returns a pair: that and the model's extra channels, of the last step
    or (B, T//k, ...) of the last step of every k."""
    T = sched.num_timesteps
    img = _randn(shape, generator, device) if x_T is None else x_T.float()
    traj: List[torch.Tensor] = [img]
    adds: List[torch.Tensor] = []
    additional = None
    if return_every is not None and T % int(return_every):
        raise ValueError("return_every must divide num_timesteps")
    nshape = noise_shape(sched, shape)
    for i, t in enumerate(range(T - 1, -1, -1)):
        bt = torch.full((shape[0],), t, dtype=torch.long, device=img.device)
        pred = model_predictions(sched, model_fn, img, bt, external_cond=external_cond,
                                 additional_channels=additional_channels)
        x_start = pred[1].clamp(-1.0, 1.0)
        if additional_channels:
            additional = pred[2]
        mean, _, log_var = q_posterior(sched, x_start, img, bt)
        noise = None
        if t > 0:
            noise = _randn(nshape, generator, device) if noises is None else noises[i]
        img = _ancestral_step(sched, mean, log_var, t, noise)
        if return_every is not None and (i + 1) % int(return_every) == 0:
            traj.append(img)
            if additional_channels:
                adds.append(additional)
    if return_every is None:
        return (img, additional) if additional_channels else img
    out = torch.stack(traj, dim=1)
    return (out, torch.stack(adds, dim=1)) if additional_channels else out


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
                return_every: Optional[int] = None, device="cuda",
                additional_channels: int = 0):
    """DDIM over ``sched.sampling_timesteps`` steps.  With eta = 0 (the
    flagship) no noise is drawn.  ``return_every=k`` returns (B, K, ...)
    with x_T, every k-th state and always the final one.  With
    ``additional_channels`` returns a pair: that and the model's extra
    channels (of the last step, or of the trajectory's steps)."""
    T, S, eta = sched.num_timesteps, sched.sampling_timesteps, sched.ddim_sampling_eta
    times = linspace_int(-1, T - 1, S + 1)[::-1]
    img = _randn(shape, generator, device) if x_T is None else x_T.float()
    traj: List[torch.Tensor] = [img]
    adds: List[torch.Tensor] = []
    ac = sched.alphas_cumprod
    one = torch.ones((), device=img.device)
    for i, (t, t_next) in enumerate(zip(times[:-1], times[1:])):
        bt = torch.full((shape[0],), t, dtype=torch.long, device=img.device)
        pred = model_predictions(
            sched, model_fn, img, bt, clip_x_start=True, rederive_pred_noise=True,
            external_cond=external_cond, additional_channels=additional_channels,
        )
        pred_noise, x_start = pred[0], pred[1]
        if additional_channels:
            adds.append(pred[2])
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
        return (img, adds[-1]) if additional_channels else img
    return _strided(traj, adds, S, return_every)


def dpmpp_sample(sched: Schedule, model_fn: ModelFn, shape: Sequence[int],
                 external_cond=None, generator: Optional[torch.Generator] = None,
                 x_T=None, noises=None, return_every: Optional[int] = None,
                 device="cuda", additional_channels: int = 0):
    """DPM-Solver++(2M) over ``sched.sampling_timesteps`` model calls (JAX
    ``dpmpp_sample``): a second-order multistep integrator of the
    probability-flow ODE in data-prediction space on the trailing grid
    ``linspace(0, T-1, S)`` (last call at t = 0), first order on the first
    and the final step; the final state is the last x0.  Deterministic: only
    x_T is drawn (``noises`` is ignored).  The step coefficients are float32
    scalars computed on the host from the schedule, as JAX computes them in
    float32.  ``return_every=k`` and ``additional_channels`` as
    ``ddim_sample``."""
    del noises
    T, S = sched.num_timesteps, sched.sampling_timesteps
    times = linspace_int(0, T - 1, S)[::-1] + [-1]
    img = _randn(shape, generator, device) if x_T is None else x_T.float()
    traj: List[torch.Tensor] = [img]
    adds: List[torch.Tensor] = []
    ac = sched.alphas_cumprod.detach().cpu()

    def lam(t):
        a = ac[t]
        return 0.5 * (torch.log(a) - torch.log1p(-a))

    prev_x0, prev_lam = None, None
    for t, t_next in zip(times[:-1], times[1:]):
        bt = torch.full((shape[0],), t, dtype=torch.long, device=img.device)
        pred = model_predictions(sched, model_fn, img, bt, clip_x_start=True,
                                 external_cond=external_cond,
                                 additional_channels=additional_channels)
        x0 = pred[1]
        if additional_channels:
            adds.append(pred[2])
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
        return (img, adds[-1]) if additional_channels else img
    return _strided(traj, adds, S, return_every)


def sample(sched: Schedule, model_fn: ModelFn, shape: Sequence[int], external_cond=None,
           generator: Optional[torch.Generator] = None, x_T=None, noises=None,
           return_every: Optional[int] = None, device="cuda", additional_channels: int = 0):
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
              return_every, device, additional_channels)


def interpolate(sched: Schedule, model_fn: ModelFn, x1, x2, t: Optional[int] = None,
                lam: float = 0.5, external_cond=None,
                generator: Optional[torch.Generator] = None, x_T=None,
                noises: Optional[Sequence[torch.Tensor]] = None, device="cuda"):
    """Interpolation of two states (JAX ``interpolate``): both noised to
    step ``t`` (default T - 1) by the forward process, mixed as
    (1 - lam) x_t1 + lam x_t2, then denoised by the ancestral steps t - 1
    down to 0.  ``x_T`` is the pair of forward-process noises of x1 and x2,
    ``noises[i]`` the noise of the i-th step (t - 1 - i); drawn from
    ``generator`` when not given."""
    t = sched.num_timesteps - 1 if t is None else int(t)
    nshape = noise_shape(sched, x1.shape)
    n1, n2 = ((_randn(nshape, generator, device), _randn(nshape, generator, device))
              if x_T is None else x_T)
    bt = torch.full((x1.shape[0],), t, dtype=torch.long, device=x1.device)
    img = (1 - lam) * q_sample(sched, x1, bt, n1) + lam * q_sample(sched, x2, bt, n2)
    for i, step in enumerate(range(t - 1, -1, -1)):
        bt = torch.full((x1.shape[0],), step, dtype=torch.long, device=x1.device)
        _, x_start = model_predictions(sched, model_fn, img, bt, external_cond=external_cond)
        x_start = x_start.clamp(-1.0, 1.0)
        mean, _, log_var = q_posterior(sched, x_start, img, bt)
        noise = None
        if step > 0:
            noise = _randn(nshape, generator, device) if noises is None else noises[i]
        img = _ancestral_step(sched, mean, log_var, step, noise)
    return img


__all__ = [
    "Schedule", "make_schedule", "extract", "model_predictions", "q_posterior",
    "predict_start_from_noise", "predict_noise_from_start", "predict_v", "p_losses",
    "pyramid_loss", "q_sample", "noise_shape", "interpolate",
    "predict_start_from_v", "p_sample_loop", "ddim_sample", "dpmpp_sample",
    "linspace_int", "sample",
]
