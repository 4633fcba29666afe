"""Port vs JAX for the standalone diffusion trainer's parts on the CPU:
``models/ema.py::ema_update`` over 30 steps (every 10th, copying through
step 100, the trainer's settings) and over a run that blends (after step
15) to 1e-6 relative; ``ImageFolderDataset`` against JAX's PIL reader on
PNGs written by PIL in RGB, L and RGBA, resized and not, with the flips,
bit for bit; a ``.jpg`` in the folder raising; and a 2-step ``Trainer`` run
on ``Unet(16, dim_mults=(1, 2))`` with 8 PNGs at 16x16, as JAX's
``test_standalone_trainer_tiny``: the step count, the EMA's steps,
``sample-1.png``, the checkpoint holding the state and the EMA, and a
finite Frechet value under its honest name."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from opticalflowdiffusion_tpu.models.ema import EmaState as JEma
from opticalflowdiffusion_tpu.models.ema import ema_update as jema_update
from opticalflowdiffusion_tpu.training.standalone import ImageFolderDataset as JFolder
from opticalflowdiffusion_tpu_torch.models import diffusion as dm
from opticalflowdiffusion_tpu_torch.models.ema import EmaState, ema_update
from opticalflowdiffusion_tpu_torch.models.unet import Unet
from opticalflowdiffusion_tpu_torch.training.standalone import ImageFolderDataset, Trainer
from opticalflowdiffusion_tpu_torch.utils.fid import default_feature_fn


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("after", [100, 15])
def test_ema_update_matches_jax(after):
    rng = np.random.default_rng(after)
    shapes = {"w": (3, 4), "b": (5,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jema = JEma.create({k: jnp.asarray(v) for k, v in init.items()})
    pema = EmaState.create({k: torch.from_numpy(v) for k, v in init.items()})
    for _ in range(30):
        params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jema = jema_update(jema, {k: jnp.asarray(v) for k, v in params.items()}, 0.995, 10,
                           after)
        pema = ema_update(pema, {k: torch.from_numpy(v) for k, v in params.items()}, 0.995, 10,
                          after)
        assert pema.step == int(jema.step)
        for k in shapes:
            np.testing.assert_allclose(pema.params[k].numpy(), np.asarray(jema.params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def _pil_folder(folder: Path, rng, size=20):
    folder.mkdir(parents=True)
    for i, mode in enumerate(("RGB", "L", "RGBA", "RGB", "L", "RGBA")):
        c = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
        arr = (rng.random((size, size + 3 * i, c)) * 255).astype(np.uint8)
        Image.fromarray(arr[..., 0] if c == 1 else arr, mode).save(folder / f"img_{i}.png")
    (folder / "sub").mkdir()
    Image.fromarray((rng.random((7, 9, 3)) * 255).astype(np.uint8)).save(folder / "sub" / "x.PNG")
    (folder / "notes.txt").write_text("not an image")


@pytest.mark.parametrize("image_size", [16, 20])
def test_image_folder_matches_jax_bit_for_bit(tmp_path, image_size):
    _pil_folder(tmp_path / "f", np.random.default_rng(1))
    port, ref = ImageFolderDataset(tmp_path / "f", image_size, seed=3), JFolder(
        tmp_path / "f", image_size, seed=3)
    assert [p.name for p in port.paths] == [p.name for p in ref.paths] and len(port) == 7
    for i in [0, 1, 2, 3, 4, 5, 6, 2, 2, 0]:
        (a,), (b,) = port[i], ref[i]
        assert a.dtype == b.dtype == np.float32 and a.shape == (image_size, image_size, 3)
        np.testing.assert_array_equal(a, b)
    flat = ImageFolderDataset(tmp_path / "f", image_size, augment_horizontal_flip=False)
    np.testing.assert_array_equal(flat[0][0], JFolder(tmp_path / "f", image_size,
                                                      augment_horizontal_flip=False)[0][0])


def test_image_folder_refuses_what_it_cannot_decode(tmp_path):
    _pil_folder(tmp_path / "f", np.random.default_rng(2))
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "f" / "photo.jpg")
    with pytest.raises(ValueError, match="PNG only"):
        ImageFolderDataset(tmp_path / "f", 16)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        ImageFolderDataset(tmp_path / "empty", 16)


def test_trainer_tiny_run(tmp_path):
    rng = np.random.default_rng(0)
    folder = tmp_path / "images"
    folder.mkdir()
    for i in range(8):
        Image.fromarray((rng.random((16, 16, 3)) * 255).astype(np.uint8)).save(folder / f"{i}.png")
    sched = dm.make_schedule(4, objective="pred_noise", device="cpu")
    model = Unet(16, channels=3, out_dim=3, dim_mults=(1, 2))
    tr = Trainer(sched, model, folder, train_batch_size=4, gradient_accumulate_every=2,
                 train_lr=1e-4, train_num_steps=2, save_and_sample_every=2, num_samples=4,
                 results_folder=str(tmp_path / "results"), image_size=16, calculate_fid=True,
                 fid_feature_fn=default_feature_fn(device="cpu"), device="cpu")
    assert tr.fid_metric_name == "feature-fid"
    state, ema = tr.train()
    assert state.step == 2 and ema.step == 2
    assert (tmp_path / "results" / "sample-1.png").exists()
    ck = torch.load(tmp_path / "results" / "checkpoints" / "2" / "state.pt", weights_only=True)
    assert ck["step"] == 2 and set(ck["ema"]) == {"params", "step"}
    assert set(ck["ema"]["params"]) == {k for k, _ in model.named_parameters()}
    # the EMA fires every 10th step: after 2 it still holds the initial
    # weights, which the two steps moved away from
    moved = [not torch.equal(p, ema.params[k]) for k, p in model.named_parameters()]
    assert any(moved)
    assert tr.last_fid is not None and np.isfinite(tr.last_fid)
    with pytest.raises(ValueError, match="square"):
        Trainer(sched, Unet(8, dim_mults=(1,)), folder, num_samples=5, device="cpu",
                results_folder=str(tmp_path / "r2"))
