"""The standalone diffusion trainer (JAX ``training/standalone.py``, the
reference's Trainer): unconditional image diffusion on an image folder,
with EMA, gradient accumulation, milestone checkpoints, sample grids and
the Frechet metric.

``ImageFolderDataset`` reads every ``.png`` under a folder (sorted), converts
it to RGB as PIL's ``.convert("RGB")`` does (grey repeated, alpha dropped),
resizes it with Pillow's default BICUBIC (``data/resize.py::resize_pil``,
bit for bit) and flips it at probability 1/2 from ``default_rng(seed)``.
The port decodes PNG only (``data/png.py``: 8-bit, no palette): a folder
holding ``.jpg``, ``.jpeg`` or ``.tiff`` files, which JAX's reader opens
with PIL, raises.

``Trainer`` trains a ``models/unet.py::Unet`` (weights drawn by flax's
initialisers from ``seed``) with ``models/diffusion.py::p_losses`` on
``[-1, 1]`` images: Adam at ``train_lr`` with betas (0.9, 0.99), the batch
of ``train_batch_size * gradient_accumulate_every`` split into microbatches
by ``parallel/train.py::make_train_step``, the EMA after every step
(``models/ema.py``, over a copy of the model that then samples).  Every
``save_and_sample_every`` steps it writes a checkpoint under
``results/checkpoints/<step>`` (the train state and ``ema``), a grid of
``num_samples`` samples of the EMA model as ``sample-<k>.png`` and, with
``calculate_fid``, the Frechet distance between up to 256 of the folder's
images and the samples (``utils/fid.py``), printed under the honest name:
``feature-fid`` with a given feature function, else ``surrogate-fid``.
"""

from __future__ import annotations

import copy
import math
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..data import png
from ..data.loader import DataLoader
from ..data.resize import resize_pil
from ..experiments.base import to_device
from ..models import diffusion as dm
from ..models.ema import EmaState, ema_update
from ..models.unet import Unet, init_weights
from ..parallel.train import TrainState, make_optimizer, make_train_step
from ..utils import visualization as viz
from ..utils.ckpt import CheckpointManager
from ..utils.fid import fid_between

EXTS = (".jpg", ".jpeg", ".png", ".tiff")


def read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG, as PIL's ``Image.open(p).convert("RGB")``."""
    img = png.decode_png(Path(path).read_bytes())
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit PNG; the image folder takes 8-bit PNGs")
    if img.shape[2] in (2, 4):
        img = img[..., :-1]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img)


class ImageFolderDataset:
    """Flat image-folder dataset (module docstring)."""

    def __init__(self, folder, image_size: int, augment_horizontal_flip: bool = True,
                 seed: int = 0):
        self.paths = sorted(p for p in Path(folder).rglob("*") if p.suffix.lower() in EXTS)
        if not self.paths:
            raise FileNotFoundError(f"no images under {folder}")
        other = [p for p in self.paths if p.suffix.lower() != ".png"]
        if other:
            raise ValueError(
                f"{len(other)} images under {folder} are not PNG (first: {other[0].name}): the "
                "port decodes PNG only (no JPEG or TIFF decoder); convert them to PNG")
        self.image_size = image_size
        self.flip = augment_horizontal_flip
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        img = resize_pil(read_rgb(self.paths[idx]), (self.image_size, self.image_size))
        arr = img.astype(np.float32) / 255.0
        if self.flip and self._rng.random() < 0.5:
            arr = arr[:, ::-1].copy()
        return (arr,)


class Trainer:
    """Unconditional diffusion training loop (module docstring); ``device``
    defaults to cuda."""

    def __init__(
        self,
        sched: dm.Schedule,
        model: Unet,
        folder,
        *,
        train_batch_size: int = 16,
        gradient_accumulate_every: int = 1,
        train_lr: float = 1e-4,
        train_num_steps: int = 100000,
        ema_update_every: int = 10,
        ema_decay: float = 0.995,
        adam_betas=(0.9, 0.99),
        save_and_sample_every: int = 1000,
        num_samples: int = 25,
        results_folder: str = "./results",
        calculate_fid: bool = False,
        fid_feature_fn: Optional[Callable] = None,
        fid_metric_name: Optional[str] = None,
        image_size: int = 32,
        seed: int = 0,
        device="cuda",
    ):
        if math.isqrt(num_samples) ** 2 != num_samples:
            raise ValueError(f"num_samples must be a square, got {num_samples}")
        self.sched = sched
        self.device = torch.device(device)
        self.image_size = image_size
        self.num_samples = num_samples
        self.save_every = save_and_sample_every
        self.train_num_steps = train_num_steps
        self.accum = gradient_accumulate_every
        self.calculate_fid = calculate_fid
        self.fid_feature_fn = fid_feature_fn
        # honest labelling: the random-conv fallback is a surrogate, a given
        # (trained) extractor gets its own name
        self.fid_metric_name = fid_metric_name or (
            "feature-fid" if fid_feature_fn is not None else "surrogate-fid")
        self.last_fid: Optional[float] = None
        self.results = Path(results_folder)
        self.results.mkdir(parents=True, exist_ok=True)

        self.ds = ImageFolderDataset(folder, image_size)
        self.loader = DataLoader(self.ds, batch_size=train_batch_size * self.accum,
                                 shuffle=True, seed=seed)
        self.ema_decay = ema_decay
        self.ema_every = ema_update_every

        self.model = init_weights(model, torch.Generator().manual_seed(seed)).to(self.device)
        self.model.train()
        self.ema_model = copy.deepcopy(self.model).eval().requires_grad_(False)
        self.ema = EmaState(dict(self.ema_model.named_parameters()))
        self.state = TrainState(self.model, make_optimizer(self.model.parameters(), train_lr,
                                                           betas=adam_betas))
        self.ckpt = CheckpointManager(self.results / "checkpoints", self.save_every)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        def loss_fn(batch, generator):
            (imgs,) = batch
            imgs = 2.0 * imgs - 1.0                     # auto_normalize
            t = torch.randint(0, sched.num_timesteps, (imgs.shape[0],), generator=generator,
                              device=generator.device).to(imgs.device)
            noise = torch.randn(imgs.shape, generator=generator,
                                device=generator.device).to(imgs.device)
            return dm.p_losses(sched, self._model_fn(self.model), imgs, t, noise), {}

        self.loss_fn = loss_fn     # (batch, generator) -> (loss, {}): t, then the noise
        self._step_fn = make_train_step(loss_fn, accumulate=self.accum)

    @staticmethod
    def _model_fn(model):
        def fn(x, cond, t, sc=None):
            return model(x, None, t)

        return fn

    @torch.no_grad()
    def sample(self, n: int, model=None, generator: Optional[torch.Generator] = None):
        """(n, 3, S, S) samples in [0, 1] of ``model`` (default the EMA
        model), from ``generator`` (default seed 0)."""
        model = self.ema_model if model is None else model
        gen = generator or torch.Generator(device=self.device).manual_seed(0)
        shape = (n, 3, self.image_size, self.image_size)
        img = dm.sample(self.sched, self._model_fn(model), shape, generator=gen,
                        device=self.device)
        return (img + 1.0) * 0.5

    def milestone(self, step: int) -> None:
        """The checkpoint, the sample grid and the Frechet line of ``step``."""
        self.ckpt.save(self.state, self.generator, extra={"ema": self.ema.state_dict()})
        samples = self.sample(self.num_samples).permute(0, 2, 3, 1).cpu().numpy()
        viz.save_image(samples, self.results / f"sample-{step // self.save_every}.png")
        if self.calculate_fid:
            real = np.stack([self.ds[i][0] for i in range(min(len(self.ds), 256))])
            self.last_fid = fid_between(real, samples, self.fid_feature_fn, device=self.device)
            print(f"[trainer] step {step} {self.fid_metric_name}: {self.last_fid:.3f}")

    def train(self):
        step = self.state.step
        it = iter(self.loader)
        while step < self.train_num_steps:
            try:
                batch = next(it)
            except StopIteration:
                it = iter(self.loader)
                batch = next(it)
            self._step_fn(self.state, to_device(batch, self.device), self.generator)
            ema_update(self.ema, dict(self.model.named_parameters()), self.ema_decay,
                       self.ema_every)
            step += 1
            if step % self.save_every == 0:
                self.milestone(step)
        return self.state, self.ema


__all__ = ["EXTS", "ImageFolderDataset", "Trainer", "read_rgb"]
