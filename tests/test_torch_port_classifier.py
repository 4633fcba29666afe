"""Port vs JAX for the classification family, float32 on the CPU, on the
same numpy-seeded inputs and on weights carried across by
``utils/weights.py``: ResNet18's logits and pooled features at 32x32 b2 in
eval mode (BatchNorm statistics and affine perturbed) and in train mode
(with the folded running statistics), its stride-2 block on an even side
(flax's ``SAME`` pads (0, 1) there, torch's symmetric pad would not) and an
odd one, ResNet34's construction and rows, MobileNetV2 at 16x16 b2, three
``Classifier`` train steps (loss, accuracy, running mean and variance, one
Adam step's parameters), the CIFAR-10 reader on a fixture tree (items and
augmentation bit for bit), the MNIST reader (raw and gzip IDX, both file
names), the synthetic classification batch, the classifier pretraining,
``models/common.py``'s modules and ``train.py --algorithm classifier``.
Values to 1e-5 of the reference's largest value (``RTOL``); running
statistics to 1e-5 relative; Adam's first-step parameters to 1% of the
step (lr) where the two gradients' difference cannot flip the sign and
|g| is at least 100 eps (the first step is lr * g / (|g| + eps)), which
covers most of each leaf: in
train mode flax's BatchNorm takes the variance as E[x^2] - E[x]^2, which
cancels on channels whose mean dwarfs their spread (ResNet18's last block
here), so float32 rounding moves a few gradients by percents on both sides;
MobileNetV2 in train mode to 1e-4 (``MOBILENET_TRAIN_RTOL``)."""

import gzip
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from opticalflowdiffusion_tpu.algorithms.classifier import Classifier as JClassifier
from opticalflowdiffusion_tpu.config import Config
from opticalflowdiffusion_tpu.data.cifar10 import CIFAR10Dataset as JCIFAR
from opticalflowdiffusion_tpu.data.mnist import MNISTDataset as JMNIST
from opticalflowdiffusion_tpu.models import common as jcommon
from opticalflowdiffusion_tpu.models import mobilenet as jmob
from opticalflowdiffusion_tpu.models import resnet as jres
from opticalflowdiffusion_tpu.training import classifier_pretrain as jpre
from opticalflowdiffusion_tpu_torch import train as ptrain
from opticalflowdiffusion_tpu_torch.algorithms.classifier import Classifier
from opticalflowdiffusion_tpu_torch.config import Cifar10DataConfig, ClassifierConfig
from opticalflowdiffusion_tpu_torch.data import fixtures
from opticalflowdiffusion_tpu_torch.data.cifar10 import CIFAR10Dataset
from opticalflowdiffusion_tpu_torch.data.mnist import MNISTDataset
from opticalflowdiffusion_tpu_torch.models import common as pcommon
from opticalflowdiffusion_tpu_torch.models import mobilenet as pmob
from opticalflowdiffusion_tpu_torch.models import resnet as pres
from opticalflowdiffusion_tpu_torch.parallel.train import TrainState, make_optimizer, make_train_step
from opticalflowdiffusion_tpu_torch.training import classifier_pretrain as ppre
from opticalflowdiffusion_tpu_torch.utils import weights as W

RTOL = 1e-5
# MobileNetV2 in train mode at 16x16 b2: its 2x2 stages normalise each
# channel over 8 values, where E[x^2] - E[x]^2 cancels and float32 rounding
# in the two sides' reductions (summed in other orders) grows ~5x
MOBILENET_TRAIN_RTOL = 1e-4
LR = 1e-3          # algorithm/classifier.yaml


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _close(got, want, rtol=RTOL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{msg}: max err {err:.3g} vs {rtol:g} x {scale:.3g}"


def _perturbed(variables, rng):
    """``{"net", "batch_stats"}`` with BatchNorm's scale, bias, mean and
    variance drawn away from their initial values, so every term counts."""
    def bump(path, a):
        name = str(path[-1].key)
        a = np.asarray(a)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    tree = {"net": variables["params"], "batch_stats": variables["batch_stats"]}
    return jax.tree_util.tree_map_with_path(bump, jax.device_get(tree))


def _flax_vars(tree):
    return {"params": tree["net"], "batch_stats": tree["batch_stats"]}


# ------------------------------------------------------------------ ResNet
@pytest.fixture(scope="module")
def resnet18_case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    m = jres.ResNet18()
    tree = _perturbed(jax.jit(lambda k, a: m.init(k, a, train=False))(jax.random.PRNGKey(0), x),
                      rng)
    v = _flax_vars(tree)

    @jax.jit
    def evaluate(v, a):
        return m.apply(v, a, train=False), m.apply(v, a, train=False, features=True)

    @jax.jit
    def train(v, a):
        logits, upd = m.apply(v, a, train=True, mutable=["batch_stats"])
        feats, _ = m.apply(v, a, train=True, features=True, mutable=["batch_stats"])
        return logits, feats, upd["batch_stats"]

    logits, feats = evaluate(v, x)
    tl, tf, stats = train(v, x)
    return dict(x=x, tree=tree, eval=logits, features=feats, train=tl, train_features=tf,
                stats=jax.device_get(stats))


def test_resnet18_eval_logits_and_features_match_jax(resnet18_case):
    c = resnet18_case
    net = pres.ResNet18()
    net.load_state_dict(W.resnet_state_dict(c["tree"]))
    net.eval()
    with torch.no_grad():
        _close(net(_nchw(c["x"])), c["eval"], msg="logits")
        _close(net(_nchw(c["x"]), features=True), c["features"], msg="features")
    assert c["features"].shape == (2, 512)


def test_resnet18_train_mode_and_running_stats_match_jax(resnet18_case):
    """Train mode normalises by the batch's biased statistics and folds them
    into the buffers at momentum 0.99, as flax does (torch's BatchNorm2d
    would fold the unbiased variance at 0.1)."""
    c = resnet18_case
    net = pres.ResNet18()
    net.load_state_dict(W.resnet_state_dict(c["tree"]))
    net.train()
    with torch.no_grad():
        _close(net(_nchw(c["x"])), c["train"], msg="train logits")
    got = W.resnet_jax_layout(net.state_dict(), c["tree"])["batch_stats"]
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(c["stats"])):
        _close(g, w, msg=jax.tree_util.keystr(path))
    with torch.no_grad():
        _close(net(_nchw(c["x"]), features=True), c["train_features"], msg="train features")


@pytest.mark.parametrize("side", [8, 7])
def test_stride2_block_same_padding_matches_jax(side):
    """A stride-2 BasicBlock (3x3 stride 2, 1x1 stride-2 projection): on an
    even side flax pads the 3x3 by (0, 1), and the port with it; torch's
    symmetric (1, 1) would shift the grid."""
    rng = np.random.default_rng(side)
    x = rng.standard_normal((2, side, side, 64)).astype(np.float32)
    m = jres.BasicBlock(128, 2)
    tree = _perturbed(m.init(jax.random.PRNGKey(1), x, train=False), rng)
    want = m.apply(_flax_vars(tree), x, train=False)
    # the second block of a (1, 1, 0, 0) ResNet is this one: 64 -> 128 at stride 2
    rows = [((path[0],) + path[2:], key[len("layers.1."):], kind)
            for path, key, kind in W.resnet_rows((1, 1, 0, 0)) if key.startswith("layers.1.")]
    block = pres.BasicBlock(64, 128, 2)
    assert len(rows) == len(jax.tree_util.tree_leaves(tree)) == len(block.state_dict())
    block.load_state_dict(W.from_jax(tree, rows))
    block.eval()
    with torch.no_grad():
        got = block(_nchw(x))
        _close(got.permute(0, 2, 3, 1), want, msg="block")
        sym = F.conv2d(_nchw(x), block.conv1.weight, stride=2, padding=1)
        port = block.conv1(_nchw(x))
    if side % 2 == 0:
        assert float((sym - port).abs().max()) > 1e-3      # the pad matters here
    else:
        torch.testing.assert_close(sym, port)


def test_resnet34_construction_and_rows():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    m = jres.ResNet34(num_classes=7)
    tree = _perturbed(m.init(jax.random.PRNGKey(3), x, train=False), rng)
    sd = W.resnet_state_dict(tree, (3, 4, 6, 3))
    net = pres.ResNet34(num_classes=7)
    assert set(sd) == set(net.state_dict())
    assert len(W.resnet_rows((3, 4, 6, 3))) == len(jax.tree_util.tree_leaves(tree))
    net.load_state_dict(sd)
    net.eval()
    with torch.no_grad():
        _close(net(_nchw(x)), jax.jit(lambda v, a: m.apply(v, a, train=False))(
            _flax_vars(tree), x), msg="resnet34")
    back = W.resnet_jax_layout(sd, tree, (3, 4, 6, 3))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))


@pytest.fixture(scope="module")
def mobilenet_case():
    """MobileNetV2 at 16x16 b2 (jitted: flax's eager init of its 17 blocks
    takes ~20 s here): the perturbed tree and JAX's eval and train logits."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    m = jmob.MobileNetV2()
    init = jax.jit(lambda k, a: m.init(k, a, train=False))(jax.random.PRNGKey(4), x)
    tree = _perturbed(init, rng)

    @jax.jit
    def logits(v, a):
        return (m.apply(v, a, train=False),
                m.apply(v, a, train=True, mutable=["batch_stats"])[0])

    ev, tr = logits(_flax_vars(tree), x)
    return dict(x=x, tree=tree, want={False: ev, True: tr})


@pytest.mark.parametrize("train", [False, True])
def test_mobilenet_v2_matches_jax(mobilenet_case, train):
    c = mobilenet_case
    net = pmob.MobileNetV2()
    sd = W.mobilenet_state_dict(c["tree"])
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    net.train(train)
    # the depthwise kernel: flax (3, 3, 1, planes), torch (planes, 1, 3, 3)
    assert net.layers[0].conv2.groups == net.layers[0].conv2.weight.shape[0] == 32
    with torch.no_grad():
        _close(net(_nchw(c["x"])), c["want"][train], MOBILENET_TRAIN_RTOL if train else RTOL,
               msg=f"mobilenet train={train}")


# -------------------------------------------------------------- Classifier
def test_classifier_train_steps_match_jax():
    """Three train steps of JAX's Classifier (value_and_grad, Adam at lr
    1e-3, then the mutable batch_stats folded in, as
    ``parallel/train.py`` does) against the port's ``make_train_step``:
    each step's loss and accuracy, the running statistics after the three
    steps, and the parameters after the first.  The steps run in lockstep:
    before steps 2 and 3 the port's parameters (not its running buffers,
    which fold on through the port's own steps) are set to JAX's, since a
    few first-step updates whose gradient sign float32 rounding decides
    (module docstring) would otherwise move the later losses by ~1e-3."""
    rng = np.random.default_rng(5)
    batches = [(rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, 4).astype(np.int32)) for _ in range(3)]
    cfg = Config(dict(arch="resnet18", num_class=10, in_channels=3, lr=LR))
    jalgo = JClassifier(cfg)
    jstate = jalgo.init(jax.random.PRNGKey(6), batches[0])
    jstate = jstate.replace(params=_perturbed(
        {"params": jstate.params["net"], "batch_stats": jstate.params["batch_stats"]}, rng))

    @jax.jit
    def jstep(state, images, labels):
        (loss, aux), grads = jax.value_and_grad(jalgo.loss_fn, has_aux=True)(
            state.params, (images, labels), jax.random.PRNGKey(0))
        state = state.apply_gradients(grads)
        state = state.replace(params={**state.params, **aux["__mutable__"]})
        return state, loss, aux["training/accuracy"], grads

    algo = Classifier(ClassifierConfig(), device="cpu")
    algo.module.load_state_dict(W.classifier_state_dict(jax.device_get(jstate.params)))
    state = TrainState(algo.module, make_optimizer(algo.module.parameters(), LR))
    step = make_train_step(algo.loss_fn)
    covered = []
    for i, (images, labels) in enumerate(batches):
        if i:
            with torch.no_grad():
                lock = W.classifier_state_dict(jax.device_get(jstate.params))
                for k, p in algo.module.named_parameters():
                    p.copy_(lock[k])
        jstate, jloss, jacc, jgrads = jstep(jstate, images, labels)
        metrics = step(state, (_nchw(images), torch.from_numpy(labels).long()), None)
        np.testing.assert_allclose(float(metrics["train/loss"]), float(jloss), rtol=RTOL)
        assert float(metrics["training/accuracy"]) == pytest.approx(float(jacc))
        if i == 0:
            net = {"net": jax.device_get(jstate.params["net"])}
            got = W.classifier_jax_layout(algo.module.state_dict(), net)["net"]
            pgrad = W.classifier_jax_layout(
                {k: p.grad for k, p in algo.module.named_parameters()}, net)["net"]
            for (path, g), (_, w), (_, gj), (_, gp) in zip(
                    jax.tree_util.tree_leaves_with_path(got),
                    jax.tree_util.tree_leaves_with_path(net["net"]),
                    jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads["net"])),
                    jax.tree_util.tree_leaves_with_path(pgrad)):
                name = jax.tree_util.keystr(path)
                gj, gp = np.asarray(gj), np.asarray(gp)
                # Adam's first step is lr * g / (|g| + eps): compare it where
                # the two gradients' difference cannot flip the sign and eps
                # (1e-8) does not weigh in
                sure = (np.abs(gj) > 10 * np.abs(gp - gj)) & (np.abs(gj) > 100 * 1e-8)
                covered.append(sure.mean())
                np.testing.assert_allclose(np.asarray(g)[sure], np.asarray(w)[sure], rtol=1e-5,
                                           atol=1e-2 * LR, err_msg=name)
    assert np.median(covered) > 0.9, covered
    got = W.classifier_jax_layout(algo.module.state_dict(),
                                  {"batch_stats": jax.device_get(jstate.params["batch_stats"])})
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(got["batch_stats"]),
            jax.tree_util.tree_leaves_with_path(jax.device_get(jstate.params["batch_stats"]))):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * float(np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))
    jm, _ = jax.jit(jalgo.val_step)(jstate.params, batches[0], jax.random.PRNGKey(0))
    algo.module.train()
    pm, _ = algo.val_step((_nchw(batches[0][0]), torch.from_numpy(batches[0][1])))
    assert algo.module.training                      # val_step leaves the mode as it was
    np.testing.assert_allclose(float(pm["validation/loss"]), float(jm["validation/loss"]),
                               rtol=1e-4)
    assert float(pm["validation/accuracy"]) == pytest.approx(float(jm["validation/accuracy"]))


def test_classifier_starts_from_flax_defaults():
    """Every kernel within flax's truncated lecun_normal bound, biases 0,
    BatchNorm scale 1, running mean 0 and variance 1, as JAX's init."""
    algo = Classifier(ClassifierConfig(arch="mobilenet_v2"), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    for name, t in algo.module.state_dict().items():
        if name.endswith("running_var") or (name.endswith(".weight") and t.dim() == 1):
            assert torch.equal(t, torch.ones_like(t)), name
        elif name.endswith(("running_mean", ".bias")):
            assert not t.any(), name
        else:
            fan_in = t[0].numel()
            assert float(t.abs().max()) * fan_in ** 0.5 <= 2.0 / 0.87962566103423978 + 1e-5, name
    with pytest.raises(ValueError, match="arch"):
        Classifier(ClassifierConfig(arch="vgg"), device="cpu")


# ------------------------------------------------------------------ data
@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    fixtures.make_cifar10_fixture(root)
    return root


def test_cifar10_fixture_is_the_test_suites_tree(cifar_root):
    """The fixture writer draws ``tests/test_classification_e2e.py::_fake_cifar``'s
    tree from the same generator."""
    import pickle

    from test_classification_e2e import _fake_cifar    # tests/ is on the path, as pytest runs

    other = cifar_root.parent / "jax_cifar"
    _fake_cifar(other, np.random.default_rng(0))
    for name in ("data_batch_1", "data_batch_3", "test_batch"):
        a, b = (pickle.load(open(r / "cifar-10-batches-py" / name, "rb"), encoding="bytes")
                for r in (cifar_root, other))
        np.testing.assert_array_equal(a[b"data"], b[b"data"])
        assert [int(v) for v in a[b"labels"]] == [int(v) for v in b[b"labels"]]


@pytest.mark.parametrize("split", ["training", "test", "validation"])
def test_cifar10_items_match_jax_bit_for_bit(cifar_root, split):
    port = CIFAR10Dataset(Cifar10DataConfig(root=str(cifar_root)), split)
    ref = JCIFAR(Config(dict(root=str(cifar_root))), split)
    assert len(port) == len(ref) == (96 if split == "training" else 16)
    for i in [3, 0, 63, 70, 3, 5, 3] if split == "training" else range(16):
        (a, la), (b, lb) = port[i], ref[i]
        assert a.dtype == b.dtype == np.float32 and a.shape == (32, 32, 3)
        np.testing.assert_array_equal(a, b)
        assert la == lb


def test_cifar10_errors(cifar_root, tmp_path):
    with pytest.raises(ValueError, match="not available"):
        CIFAR10Dataset(Cifar10DataConfig(root=str(cifar_root)), "train")
    (tmp_path / "cifar-10-batches-py").mkdir()
    with pytest.raises(FileNotFoundError, match="data_batch_1"):
        CIFAR10Dataset(Cifar10DataConfig(root=str(tmp_path)), "training")


def _write_idx(path, arr, gz):
    head = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz,dotted", [(False, False), (True, False), (False, True)])
def test_mnist_reader_matches_jax(tmp_path, gz, dotted):
    rng = np.random.default_rng(7)
    base = tmp_path / "MNIST"
    base.mkdir()
    ext = ".gz" if gz else ""
    for prefix, n in (("train", 5), ("t10k", 3)):
        img = "-images.idx3-ubyte" if dotted else "-images-idx3-ubyte"
        lbl = img.replace("images", "labels").replace("idx3", "idx1")
        _write_idx(base / f"{prefix}{img}{ext}", rng.integers(0, 256, (n, 28, 28)), gz)
        _write_idx(base / f"{prefix}{lbl}{ext}", rng.integers(0, 10, n), gz)
    for split in ("training", "test"):
        port = MNISTDataset(Cifar10DataConfig(root=str(tmp_path)), split)
        ref = JMNIST(Config(dict(root=str(tmp_path))), split)
        assert len(port) == len(ref) == (5 if split == "training" else 3)
        for i in range(len(port)):
            np.testing.assert_array_equal(port[i][0], ref[i][0])
            assert port[i][0].shape == (28, 28, 1) and port[i][1] == ref[i][1]
    with pytest.raises(FileNotFoundError):
        MNISTDataset(Cifar10DataConfig(root=str(tmp_path / "none")))


# ------------------------------------------------------- pretraining
def test_synthetic_class_batch_matches_jax():
    a = ppre.synthetic_class_batch(np.random.default_rng(3), 12)
    b = jpre.synthetic_class_batch(np.random.default_rng(3), 12)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_train_classifier_publishes_its_artifact(tmp_path, monkeypatch):
    """Synthetic data without a CIFAR tree; the artifact resolves to a port
    checkpoint that a ResNet18 loads."""
    from opticalflowdiffusion_tpu_torch.utils.ckpt import load_artifact

    monkeypatch.setenv("OFD_ARTIFACT_ROOT", str(tmp_path / "store"))
    monkeypatch.setenv("OFD_DATA_ROOT", str(tmp_path / "no_data"))
    res = ppre.train_classifier(steps=2, batch=4, device="cpu", out_dir=str(tmp_path / "run"),
                                log_every=1)
    assert res["source"] == "synthetic" and res["steps"] == 2 and 0 <= res["accuracy"] <= 1
    pres.ResNet18().load_state_dict(load_artifact("classifier-feat"))


# --------------------------------------------------------- common models
def test_common_models_match_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 5)).astype(np.float32)
    img = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    emb = rng.standard_normal((2, 16)).astype(np.float32)
    small = rng.standard_normal((2, 12, 12, 3)).astype(np.float32)
    cases = [
        ("SimpleMlp", jcommon.SimpleMlp(out_dim=3, hidden_dim=8, n_layers=3), x,
         pcommon.SimpleMlp(5, out_dim=3, hidden_dim=8, n_layers=3)),
        ("CnnEncoder", jcommon.CnnEncoder(embedding_size=16), img, pcommon.CnnEncoder(16)),
        ("CnnDecoder", jcommon.CnnDecoder(embedding_size=16), emb, pcommon.CnnDecoder(16)),
        ("CustomizableCnn", jcommon.CustomizableCnn(features=(8, 16), out_dim=6), small,
         pcommon.CustomizableCnn(3, features=(8, 16), out_dim=6, in_size=12)),
        ("CustomizableCnn", jcommon.CustomizableCnn(features=(8, 4), kernel=5, strides=1),
         small, pcommon.CustomizableCnn(3, features=(8, 4), kernel=5, strides=1)),
    ]
    for name, jm, inp, pm in cases:
        params = jax.device_get(jm.init(jax.random.PRNGKey(9), inp)["params"])
        params = jax.tree_util.tree_map(
            lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
        want = np.asarray(jm.apply({"params": params}, inp))
        sd = W.common_state_dict(name, params)
        assert set(sd) == set(pm.state_dict()), name
        pm.load_state_dict(sd)
        with torch.no_grad():
            got = pm(_nchw(inp) if inp.ndim == 4 else torch.from_numpy(inp))
        got = got.permute(0, 2, 3, 1).numpy() if got.dim() == 4 else got.numpy()
        _close(got, want, msg=name)
        back = W.common_jax_layout(name, sd, params)
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                     jax.tree_util.tree_leaves_with_path(params)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{name} {path}")
    seq = rng.standard_normal((3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        pcommon.bottle(lambda a: a * 2, (torch.from_numpy(seq),)).numpy(),
        np.asarray(jcommon.bottle(lambda a: a * 2, (jnp.asarray(seq),))))


# ------------------------------------------------------------- train.py
def test_train_py_classifier_trains_validates_resumes_and_tests(cifar_root, tmp_path, capsys):
    """``train.py --algorithm classifier --dataset cifar10 --device cpu``:
    3 steps with a validation at step 2, a resume to 4, and the test task."""
    out = str(tmp_path / "run")
    common = ["--algorithm", "classifier", "--dataset", "cifar10", "--data-root",
              str(cifar_root), "--device", "cpu", "--out", out, "--check-interval", "2",
              "--workers", "2"]
    ptrain.main(common + ["--steps", "3"])
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["algorithm"] == "classifier" and first["experiment"] == "ClassificationExperiment"
    assert first["step"] == 3 and first["checkpoints"] == [3] and first["arch"] == "resnet18"
    assert np.isfinite(first["train"]["train/loss"]) and "training/accuracy" in first["train"]
    assert first["val"]["step"] == 2 and np.isfinite(first["val"]["validation/accuracy"])
    ptrain.main(common + ["--steps", "4", "--resume", "--tasks", "train,test"])
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert second["start_step"] == 3 and second["step"] == 4 and second["checkpoints"] == [3, 4]
    assert set(second["test"]) >= {"test/loss", "test/accuracy"}
    assert [json.loads(l)["step"] for l in open(f"{out}/metrics.jsonl")
            if "validation/loss" in l] == [2, 4]
