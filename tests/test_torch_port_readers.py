"""The port's real-data readers (``data/{sintel,flying_chairs,kitti_single,
fixtures,loader}.py``) against the JAX package's, which read through cv2,
on fixture trees of tens of pixels.

Pinned tolerances: every item equals the JAX reader's bit for bit (0): the
frames go through the same uint8 resize and float arithmetic, the flow
through the same float resize, and the KITTI densify equals
``cv2.inpaint(radius 20, INPAINT_NS)`` bit for bit on the invalid pixels
(mean and max absolute difference 0) and keeps the valid ones exactly.
The port's fixture trees decode to the arrays of JAX's, the loader gives
JAX's batches for a seed, two shards and two worker threads, the KITTI
memo holds under threads, and Sintel's ``test`` split raises as JAX's
does."""

import threading
from pathlib import Path

import cv2
import numpy as np
import pytest

from opticalflowdiffusion_tpu.config import Config, compose
from opticalflowdiffusion_tpu.data import fixtures as jfix
from opticalflowdiffusion_tpu.data.flow_io import read_kitti_png as jread_kitti
from opticalflowdiffusion_tpu.data.flying_chairs import FlyingChairsDataset as JChairs
from opticalflowdiffusion_tpu.data.kitti_single import KittiSingleDataset as JKitti
from opticalflowdiffusion_tpu.data.loader import DataLoader as JDataLoader
from opticalflowdiffusion_tpu.data.sintel import SintelDataset as JSintel
from opticalflowdiffusion_tpu_torch import config as pcfg
from opticalflowdiffusion_tpu_torch.data import DATASETS, fixtures, get_dataset, kitti_single
from opticalflowdiffusion_tpu_torch.data.flow_io import read_flo, read_kitti_png
from opticalflowdiffusion_tpu_torch.data.flying_chairs import FlyingChairsDataset
from opticalflowdiffusion_tpu_torch.data.kitti_single import KittiSingleDataset
from opticalflowdiffusion_tpu_torch.data.loader import DataLoader
from opticalflowdiffusion_tpu_torch.data.png import imread
from opticalflowdiffusion_tpu_torch.data.sintel import SintelDataset

SINTEL_SIZE, CHAIRS_SIZE, KITTI_SIZE = (48, 22), (40, 30), (62, 19)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same fixture trees written by the port and by JAX."""
    out = {}
    for who, mod in (("port", fixtures), ("jax", jfix)):
        root = tmp_path_factory.mktemp(who)
        mod.make_sintel_fixture(root, scenes=2, frames=13, size=SINTEL_SIZE)
        mod.make_chairs_fixture(root, n=8, size=CHAIRS_SIZE)
        mod.make_kitti_fixture(root, n=6, size=KITTI_SIZE)
        out[who] = root
    return out


def _files(root):
    return sorted(p.relative_to(root) for p in Path(root).rglob("*") if p.is_file())


def test_port_fixtures_decode_to_jax_fixtures(trees):
    port, jax_ = trees["port"], trees["jax"]
    assert _files(port) == _files(jax_)
    for rel in _files(port):
        a, b = port / rel, jax_ / rel
        if rel.suffix in (".flo", ".txt"):
            assert a.read_bytes() == b.read_bytes(), rel
        elif "flow_occ" in rel.parts:
            np.testing.assert_array_equal(imread(a, anydepth=True),
                                          cv2.imread(str(b), cv2.IMREAD_ANYDEPTH
                                                     | cv2.IMREAD_COLOR)[..., ::-1])
        else:
            np.testing.assert_array_equal(imread(a), cv2.imread(str(b))[..., ::-1])


def test_flow_io_matches_jax(trees):
    for f in sorted((trees["port"] / "KITTI").rglob("flow_occ/*.png")):
        (flow, valid), (jflow, jvalid) = read_kitti_png(f), jread_kitti(f)
        np.testing.assert_array_equal(flow, jflow)
        np.testing.assert_array_equal(valid, jvalid)
    for f in sorted((trees["port"] / "MPI_Sintel").rglob("*.flo"))[:3]:
        from opticalflowdiffusion_tpu.data.flow_io import read_flo as jread_flo
        np.testing.assert_array_equal(read_flo(f), jread_flo(f))


def _pair_items(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(port_ds)):
        got, want = port_ds[i], jax_ds[i]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("image_size", ["24,16", "48,24"])
@pytest.mark.parametrize("split", ["training", "validation"])
def test_sintel_items_equal_jax(trees, split, image_size):
    for root in trees.values():
        port = SintelDataset(pcfg.SintelDataConfig(image_size=image_size, root=str(root)), split)
        jax_ = JSintel(Config(dict(image_size=image_size, root=str(root))), split)
        assert port.split_paths == jax_.split_paths
        _pair_items(port, jax_)


def test_sintel_index_files_and_options(trees, tmp_path):
    """The ``Sintel.dat`` / ``Sintel_split.dat`` protocol, and the
    ``normalize`` and ``scale_flow`` options."""
    import shutil

    base = tmp_path / "MPI_Sintel"
    shutil.copytree(trees["port"] / "MPI_Sintel", base)
    rows, split = [], []
    for s in range(2):
        for n in range(2, 12):
            rows.append(f"sintel/training/clean/scene_{s}/frame_%04d.png "
                        f"sintel/training/flow/scene_{s}/frame_%04d.flo {n}")
            split.append("2" if n % 4 == 0 else "1")
    (base / "Sintel.dat").write_text("\n".join(rows) + "\n")
    (base / "Sintel_split.dat").write_text("\n".join(split) + "\n")
    for sp in ("training", "validation"):
        for extra in ({}, {"normalize": False, "scale_flow": True}):
            port = SintelDataset(pcfg.SintelDataConfig(image_size="24,16", root=str(base),
                                                       **extra), sp)
            jax_ = JSintel(Config(dict(image_size="24,16", root=str(base), **extra)), sp)
            assert port.split_paths == jax_.split_paths
            assert len(port) == (16 if sp == "training" else 4)
            _pair_items(port, jax_)


def test_sintel_test_split_raises_as_jax(trees):
    cfg = dict(image_size="24,16", root=str(trees["port"]))
    with pytest.raises(AssertionError, match="training or validation"):
        JSintel(Config(cfg), "test")
    with pytest.raises(AssertionError, match="training or validation"):
        SintelDataset(pcfg.SintelDataConfig(**cfg), "test")


@pytest.mark.parametrize("image_size", ["24,16", "64,48"])
@pytest.mark.parametrize("split", ["training", "validation", "test"])
def test_chairs_items_equal_jax(trees, split, image_size):
    for root in trees.values():
        port = FlyingChairsDataset(pcfg.FlyingChairsDataConfig(image_size=image_size,
                                                               root=str(root)), split)
        jax_ = JChairs(Config(dict(image_size=image_size, root=str(root))), split)
        assert [tuple(map(str, r)) for r in port.records] == \
            [tuple(map(str, r)) for r in jax_.records]
        _pair_items(port, jax_)


@pytest.mark.parametrize("image_size", ["64,20", "32,16"])
@pytest.mark.parametrize("split", ["training", "test"])
def test_kitti_items_equal_jax(trees, split, image_size):
    """KITTI items against JAX's (cv2.inpaint inside): bit for bit, so the
    densify's difference from cv2 on the invalid pixels is 0 (mean and
    max), and the valid pixels are the file's."""
    root = trees["port"]
    port = KittiSingleDataset(pcfg.KittiSingleDataConfig(image_size=image_size,
                                                         root=str(root)), split)
    jax_ = JKitti(Config(dict(image_size=image_size, root=str(root))), split)
    _pair_items(port, jax_)
    for _, _, pf in port.records:
        flow, valid = read_kitti_png(pf)
        dense, jdense = port._densify(pf), jax_._densify(pf)
        diff = np.abs(dense - jdense)[~valid]
        assert diff.max() == 0.0 and diff.mean() == 0.0
        np.testing.assert_array_equal(dense[valid], flow[valid])
        assert (~valid).mean() > 0.5                      # the fixture is sparse


def test_densify_numpy_version_equals_helper(trees):
    pf = sorted((trees["port"] / "KITTI" / "val").rglob("flow_occ/*.png"))[0]
    flow, valid = read_kitti_png(pf)
    dense = KittiSingleDataset(pcfg.KittiSingleDataConfig(root=str(trees["port"])),
                               "test")._densify(pf)
    for c in range(2):
        np.testing.assert_array_equal(
            kitti_single.inpaint_ns_plain(flow[..., c], ~valid, kitti_single.INPAINT_RADIUS),
            dense[..., c])


def test_kitti_memo_under_threads(trees, monkeypatch):
    """Sixteen threads (more than most CPUs have cores), switching every 10
    us, read every item many times through a memo of 2 entries (constant
    eviction): no error, the memo never above its size, and every item
    equals a serial read (JAX's unguarded eviction races here)."""
    import sys

    monkeypatch.setattr(kitti_single, "CACHE_SIZE", 2)
    cfg = pcfg.KittiSingleDataConfig(image_size="32,16", root=str(trees["port"]))
    ref = [KittiSingleDataset(cfg)[i] for i in range(6)]
    ds = KittiSingleDataset(cfg)
    errors, sizes = [], []

    def work(t):
        try:
            for k in range(12):
                i = (t + k) % len(ds)
                for g, w in zip(ds[i], ref[i]):
                    np.testing.assert_array_equal(g, w)
                sizes.append(len(ds._dense_cache))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:1]
    assert len(sizes) == 16 * 12 and max(sizes) <= 2


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shard", [0, 1])
def test_loader_batches_equal_jax(trees, shard, drop_last):
    """The port's loader on the port's reader against JAX's loader on
    JAX's reader: the same batches in the same order for seed 3, shard
    ``shard`` of 2, two worker threads, over two epochs (batch 3: the last
    one partial without ``drop_last``)."""
    root = str(trees["port"])
    port = DataLoader(SintelDataset(pcfg.SintelDataConfig(image_size="24,16", root=root)), 3,
                      True, 3, drop_last=drop_last, num_shards=2, shard_index=shard,
                      num_workers=2)
    jax_ = JDataLoader(JSintel(Config(dict(image_size="24,16", root=root))), 3, True, 3,
                       drop_last=drop_last, num_shards=2, shard_index=shard, num_workers=2)
    assert len(port) == len(jax_) == (3 if drop_last else 4)
    for _ in range(2):
        got, want = list(port), list(jax_)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_loader_skip_resumes_mid_epoch(trees):
    ds = SintelDataset(pcfg.SintelDataConfig(image_size="24,16", root=str(trees["port"])))
    full = list(DataLoader(ds, 4, True, 1, num_workers=2))
    loader = DataLoader(ds, 4, True, 1, num_workers=2)
    loader.skip = 2
    rest = list(loader)
    assert len(rest) == len(full) - 2
    for g, w in zip(rest, full[2:]):
        np.testing.assert_array_equal(g[0], w[0])


def test_registry_and_configs_match_jax():
    assert DATASETS == ("artificial", "sintel", "flying_chairs", "kitti_single",
                        "artificial_video")
    assert get_dataset("sintel") is SintelDataset
    assert get_dataset("flying_chairs") is FlyingChairsDataset
    assert get_dataset("kitti_single") is KittiSingleDataset
    with pytest.raises(KeyError):
        get_dataset("buck_bunny_video")
    with pytest.raises(NotImplementedError, match="A8"):       # waits for the RAFT port
        get_dataset("taichi")
    for name, port in (("sintel", pcfg.SINTEL), ("flying_chairs", pcfg.FLYING_CHAIRS),
                       ("kitti_single", pcfg.KITTI_SINGLE)):
        cfg = compose(["experiment=matrix_flow", "algorithm=flow_diffuser",
                       f"dataset={name}"])
        assert port.name == cfg.dataset.name
        assert port.image_size == str(cfg.dataset.image_size)
        assert port.root == cfg.dataset.root
        assert pcfg.DATA[name] is port
        assert pcfg.MATRIX_FLOW.num_workers == cfg.experiment.training.data.num_workers
        assert pcfg.MATRIX_FLOW.epochs == cfg.experiment.epochs
    assert pcfg.SINTEL.normalize is True and pcfg.SINTEL.scale_flow is False
