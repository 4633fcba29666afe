"""The Frechet distance over image features (JAX ``utils/fid.py``, the
reference's pytorch-fid usage).

``frechet_distance`` is pytorch-fid's formula.  The trace of
``sqrtm(sigma1 @ sigma2)`` is the sum of the square roots of that product's
eigenvalues, which are real and non-negative for covariances up to
rounding: it is taken from ``numpy.linalg.eigvals`` (the port has no
scipy), with the real part of each complex root as JAX keeps the real part
of scipy's ``sqrtm``, and JAX's retry with ``eps`` added to both diagonals
when the result is not finite.

The feature functions take (N, H, W, C) images in [0, 1] (numpy or a
tensor; 1 channel is repeated, 2 get a zero third, more are cut to 3) and
give (N, D) float32 numpy features.  ``default_feature_fn`` is JAX's fixed
random conv bank, which JAX draws with ``jax.random.normal``: the port
carries that draw for seed 0 and dim 64 (``randconv_seed0_dim64.npz``,
written once from JAX and held to its draw by the tests) and raises for any
other.  ``classifier_feature_fn`` is a trained classifier's pooled
512-d embedding (``models/resnet.py``, ``features=True``) over a port state
dict, checkpoint or artifact (``training/classifier_pretrain.py`` publishes
``classifier-feat``; JAX's bundled one is orbax and is bridged by
``python tests/test_torch_port_fid.py --bridge OUT_DIR``), the input
resized to the classifier's side by ``jax.image.resize``'s antialiased
bilinear (``ops/warp.py::resize``).  ``auto_feature_fn`` prefers the
classifier and falls back, loudly, to the bank; its second value names
which, for the metric keys (``frechet_classifier`` / ``frechet_randconv``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.pwc_net import same_pads

BANK = Path(__file__).with_name("randconv_seed0_dim64.npz")


def feature_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def _sqrtm_trace(m: np.ndarray) -> float:
    """trace(sqrtm(m)).real for a product of two covariances: the sum of the
    real parts of the principal square roots of its eigenvalues."""
    ev = np.linalg.eigvals(m).astype(np.complex128)
    return float(np.sqrt(ev).real.sum())


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """pytorch_fid.fid_score.calculate_frechet_distance's formula."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    tr_covmean = _sqrtm_trace(sigma1.dot(sigma2))
    if not np.isfinite(tr_covmean):
        offset = np.eye(sigma1.shape[0]) * eps
        tr_covmean = _sqrtm_trace((sigma1 + offset).dot(sigma2 + offset))
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def _adapt_channels(x: torch.Tensor) -> torch.Tensor:
    """Coerce NHWC input to exactly 3 channels: grayscale repeats, 2-channel
    (flow) inputs get a zero third channel, more than 3 are cut."""
    c = x.shape[-1]
    if c == 3:
        return x
    if c == 1:
        return x.repeat_interleave(3, dim=-1)
    if c == 2:
        return torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
    return x[..., :3]


def _nchw(images, device) -> torch.Tensor:
    """(N, H, W, C) images -> (N, 3, H, W) float32 on ``device``."""
    x = torch.as_tensor(np.asarray(images) if not isinstance(images, torch.Tensor) else images)
    return _adapt_channels(x.to(device=device, dtype=torch.float32)).permute(0, 3, 1, 2)


def _conv_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, stride, "SAME")`` of NCHW ``x``."""
    k = w.shape[-1]
    (t, b), (l, r) = (same_pads(n, stride, k) for n in x.shape[-2:])
    return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=stride)


def default_feature_fn(dim: int = 64, seed: int = 0, device="cuda") -> Callable:
    """JAX's fixed random conv bank (not Inception; module docstring)."""
    if (dim, seed) != (64, 0):
        raise ValueError(
            f"the port carries JAX's random-conv bank for seed 0 and dim 64 only (JAX draws it "
            f"with jax.random.normal, whose bits torch cannot draw), not seed {seed}, dim {dim}")
    with np.load(BANK) as bank:
        w1, w2 = (torch.from_numpy(bank[k].transpose(3, 2, 0, 1).copy()).to(device)
                  for k in ("w1", "w2"))

    @torch.no_grad()
    def fn(images) -> np.ndarray:
        x = F.relu(_conv_same(_nchw(images, w1.device), w1, 2))
        return _conv_same(x, w2, 2).mean(dim=(2, 3)).cpu().numpy()

    return fn


def _classifier_state(source) -> dict:
    """A ResNet state_dict from ``source``: a state_dict, a port checkpoint
    (``{"module": ...}``), or the name or path of a port run or artifact."""
    if isinstance(source, (str, Path)):
        from .ckpt import load_artifact

        return load_artifact(source)
    return source["module"] if "module" in source else source


def classifier_feature_fn(source, arch: str = "resnet18", num_class: int = 10,
                          image_size: int = 32, device="cuda") -> Callable:
    """The penultimate pooled features of a trained classifier (module
    docstring); images of any side are resized to ``image_size``."""
    from ..models.resnet import ResNet18, ResNet34

    module = {"resnet18": ResNet18, "resnet34": ResNet34}[arch](num_class)
    module.load_state_dict(_classifier_state(source))
    module.to(device).eval()

    @torch.no_grad()
    def fn(images) -> np.ndarray:
        from ..ops.warp import resize

        x = _nchw(images, device)
        if tuple(x.shape[-2:]) != (image_size, image_size):
            x = resize(x, (image_size, image_size))
        return module(x, features=True).cpu().numpy()

    return fn


def auto_feature_fn(artifact: str = "classifier-feat", device="cuda"):
    """(feature_fn, source): the trained classifier's features when
    ``artifact`` resolves and loads, else the random-conv bank, with a
    warning that carries the failure; ``source`` ('classifier' or
    'randconv') names which, for the metric keys."""
    try:
        return classifier_feature_fn(artifact, device=device), "classifier"
    except Exception as e:   # the loud fallback: any failure to load is reported
        import warnings

        warnings.warn(
            f"auto_feature_fn: '{artifact}' did not resolve ({e!r}); falling back to the "
            "random-conv feature bank — Frechet values will be recorded as "
            "'frechet_randconv', NOT classifier features.", stacklevel=2)
        return default_feature_fn(device=device), "randconv"


def fid_between(real, fake, feature_fn: Optional[Callable] = None, device="cuda") -> float:
    """The Frechet distance between two (N, H, W, C) image sets in [0, 1];
    without ``feature_fn`` that of :func:`auto_feature_fn`."""
    if feature_fn is None:
        feature_fn, _ = auto_feature_fn(device=device)
    f_real = np.asarray(feature_fn(real))
    f_fake = np.asarray(feature_fn(fake))
    return frechet_distance(*feature_stats(f_real), *feature_stats(f_fake))


__all__ = ["BANK", "auto_feature_fn", "classifier_feature_fn", "default_feature_fn",
           "feature_stats", "fid_between", "frechet_distance"]
