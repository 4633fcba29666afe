"""Port vs JAX for the TaiChi reader and its flow precompute
(``data/taichi.py``), PIL's default resize (``data/resize.py::resize_pil``)
and the TaiChi entry points, on the CPU.  PIL and cv2 are imported here
only (JAX's reader uses them), never in the port.

- ``resize_pil`` equals ``PIL.Image.resize`` (BICUBIC) bit for bit at
  shrinking, growing and mixed sizes.
- On a fixture tree (48x48 frames read at 32, some videos dropped by
  ``scale_down``, ``mod`` sharding, caches channels-last at 24x24 through
  cv2's float bilinear and channels-first at 32x32) the port's items equal
  JAX's: the frames bit for bit, the flows within 1e-6.
- The precompute on the same weights (JAX's untrained RAFT from PRNGKey(0),
  carried into a port run): every cached flow within 1e-5 of JAX's largest
  value; without a checkpoint both refuse unless ``allow_untrained_flow``.
- ``train.py --algorithm frame_generator --dataset taichi
  --calculate-flows`` trains, validates and resumes on a fixture tree."""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.config import Config
from opticalflowdiffusion_tpu.data.taichi import TaiChiDataset as JTaiChi
from opticalflowdiffusion_tpu.models.raft import RAFT as JRAFT
from opticalflowdiffusion_tpu_torch import train as train_entry
from opticalflowdiffusion_tpu_torch.config import TAICHI
from opticalflowdiffusion_tpu_torch.data import fixtures
from opticalflowdiffusion_tpu_torch.data.resize import resize_pil
from opticalflowdiffusion_tpu_torch.data.taichi import TaiChiDataset
from opticalflowdiffusion_tpu_torch.utils.weights import raft_state_dict

S = 32          # the size read
FD = 2          # frame_distance


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("src,dst", (((48, 48), (32, 32)), ((256, 256), (64, 64)),
                                     ((30, 41), (64, 17)), ((17, 23), (17, 50)),
                                     ((5, 7), (2, 3))))
def test_resize_pil_matches_pil(src, dst):
    from PIL import Image

    rng = np.random.default_rng(sum(src + dst))
    smooth = (np.add.outer(np.arange(src[0]), 3 * np.arange(src[1])) * 5 % 256)
    for img in (rng.integers(0, 256, src + (3,), dtype=np.uint8),
                np.repeat(smooth[..., None], 3, axis=2).astype(np.uint8)):
        want = np.asarray(Image.fromarray(img).resize(dst[::-1]))
        np.testing.assert_array_equal(resize_pil(img, dst[::-1]), want)


def _tree(root):
    """A fixture tree and flow caches: video 0's channels-last at 24x24,
    video 2's channels-first at 32x32, the others' channels-last at 32x32
    (``scale_down`` 0.7 keeps videos 0 and 2: random.Random(14) draws 0.107,
    0.703, 0.652, 0.940)."""
    fixtures.make_taichi_fixture(root, videos=4, frames=6, size=48, seed=2)
    rng = np.random.default_rng(9)
    for split in ("training", "test"):
        base = root / "taichi" / "taichi" / split
        for v, vid in enumerate(sorted(base.iterdir())):
            out = base.parent / f"{split}-flows2" / vid.name
            out.mkdir(parents=True)
            for frame in sorted(vid.iterdir()):
                shape = (24, 24, 2) if v == 0 else (2, S, S) if v == 2 else (S, S, 2)
                np.save(out / (frame.name + ".npy"), rng.uniform(-3, 3, shape).astype(np.float32))


def _cfgs(root, **fields):
    """(JAX's config, the port's) of a tree: ``fields`` over the common
    ones; the port's ``flow_checkpoint`` stays its default."""
    common = dict(image_size=S, frame_distance=FD, val_length=2, root=str(root),
                  scale_down=0.7, calculate_flows=False, flow_method="raft")
    common.update(fields)
    port = dataclasses.replace(TAICHI, flow_device="cpu", **{
        k: v for k, v in common.items() if k != "flow_checkpoint"})
    return Config(dict(name="taichi", **common)), port


@pytest.mark.parametrize("split,mod", (("training", "0,0"), ("validation", "0,0"),
                                       ("training", "1,2")))
def test_reader_matches_jax(tmp_path, split, mod):
    _tree(tmp_path)
    jcfg, pcfg = _cfgs(tmp_path)
    want = JTaiChi(jcfg, split=split, mod=mod)
    got = TaiChiDataset(pcfg, split=split, mod=mod)
    assert got.split == want.split
    assert got.first_frames == want.first_frames and got.second_frames == want.second_frames
    assert got.flows == want.flows and len(got) == len(want) > 0
    kept = {p.split("/")[-2] for p in got.first_frames}
    assert 0 < len(kept) < 4                     # scale_down dropped a video
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_array_equal(g[..., :6], w[..., :6])
        np.testing.assert_allclose(g[..., 6:], w[..., 6:], rtol=1e-6, atol=1e-6)


def test_cache_path_renames_the_split_segment_only(tmp_path):
    root = tmp_path / "training"                 # the split's name in the prefix too
    fixtures.make_taichi_fixture(root, videos=1, frames=3, size=16, splits=("training",))
    (root / "taichi" / "taichi" / "training-flows2").mkdir()
    ds = TaiChiDataset(dataclasses.replace(TAICHI, root=str(root), frame_distance=1,
                                           image_size=16))
    path = ds.flows[0]
    assert path.startswith(str(root) + "/") and "/taichi/training-flows2/" in path
    assert path.endswith(".png.npy")


def test_precompute_matches_jax_on_the_same_weights(tmp_path):
    """JAX's precompute on its untrained RAFT (PRNGKey(0), as its
    ``allow_untrained_flow`` path draws it) against the port's on those
    weights carried into a port run: every cache file."""
    fixtures.make_taichi_fixture(tmp_path / "jax", videos=3, frames=4, size=48, seed=5)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    arch = dict(flow_iters=2, flow_corr_levels=2, flow_batch_size=64)
    dummy = jnp.zeros((1, S, S, 3))
    params = JRAFT(iters=2, corr_levels=2).init(jax.random.PRNGKey(0), dummy, dummy)["params"]
    run = tmp_path / "run" / "checkpoints" / "0"
    run.mkdir(parents=True)
    torch.save({"step": 0, "module": raft_state_dict(jax.device_get(params))}, run / "state.pt")
    jcfg, _ = _cfgs(tmp_path / "jax", calculate_flows=True, allow_untrained_flow=True,
                    flow_checkpoint=None, **arch)
    with jax.default_matmul_precision("highest"):
        want = JTaiChi(jcfg, split="training")
    _, pcfg = _cfgs(tmp_path / "port", calculate_flows=True, **arch)
    got = TaiChiDataset(dataclasses.replace(pcfg, flow_checkpoint=str(tmp_path / "run")),
                        split="training")
    assert len(got) == len(want) > 0
    for gp, wp in zip(got.flows, want.flows):
        g, w = np.load(gp), np.load(wp)
        assert g.shape == w.shape == (S, S, 2)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), (gp, np.abs(g - w).max())
    assert np.abs(w).max() > 0


def test_precompute_refuses_untrained_weights(tmp_path):
    fixtures.make_taichi_fixture(tmp_path, videos=1, frames=3, size=16, splits=("training",))
    jcfg, pcfg = _cfgs(tmp_path, calculate_flows=True, frame_distance=1)
    with pytest.raises(ValueError, match="flow_checkpoint"):
        JTaiChi(jcfg, split="training")
    with pytest.raises(ValueError, match="flow_checkpoint"):
        TaiChiDataset(dataclasses.replace(pcfg, flow_checkpoint=None), split="training")


def test_train_on_taichi_with_the_precompute(tmp_path, capsys):
    """FrameGenerator on a TaiChi fixture (frame_distance 10: 2 pairs a
    video of 12 frames): the precompute from a RAFT run,
    two steps and a validation, then a resume to three."""
    fixtures.make_taichi_fixture(tmp_path / "data", videos=2, frames=12, size=48)
    run = tmp_path / "raft" / "checkpoints" / "0"
    run.mkdir(parents=True)
    from opticalflowdiffusion_tpu_torch.models.raft import RAFT
    from opticalflowdiffusion_tpu_torch.models.unet import init_weights

    net = init_weights(RAFT(iters=2, corr_levels=2), torch.Generator().manual_seed(0))
    torch.save({"step": 0, "module": net.state_dict()}, run / "state.pt")
    args = ["--algorithm", "frame_generator", "--dataset", "taichi", "--device", "cpu",
            "--data-root", str(tmp_path / "data"), "--image-size", "16", "--batch", "2",
            "--val-batch", "2", "--val-length", "2", "--sampling-timesteps", "2",
            "--precision", "float32", "--calculate-flows", "--flow-checkpoint",
            str(tmp_path / "raft"), "--flow-iters", "2", "--flow-corr-levels", "2",
            "--out", str(tmp_path / "fg")]
    train_entry.main(args + ["--steps", "2"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["dataset"] == "taichi" and res["step"] == 2 and res["checkpoints"] == [2]
    assert np.isfinite(res["val"]["val/loss"])
    assert len(list((tmp_path / "data" / "taichi" / "taichi" / "test-flows2").rglob("*.npy")))
    train_entry.main(args + ["--steps", "3", "--resume"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["start_step"] == 2 and res["step"] == 3
