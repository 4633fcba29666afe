"""Port vs JAX for the Frechet metric (``utils/fid.py``) on the CPU:
``frechet_distance`` (the trace of the matrix square root from the
eigenvalues, no scipy) against JAX's scipy ``sqrtm`` to 1e-6 relative on
well-conditioned statistics and on a singular pair, and on that pair when
the square root comes back non-finite (JAX's ``eps`` retry, forced on both
sides); the committed random-conv bank against JAX's ``jax.random.normal``
draw bit for bit; ``default_feature_fn`` on 1, 2, 3 and 4 channels and
``classifier_feature_fn`` on 64x64 inputs (resized to 32) against JAX's on
the same weights, to 1e-5 of the largest feature; ``auto_feature_fn``'s
loud fallback and its sources; ``fid_between``; JAX's bundled
``classifier-feat`` (orbax) bridged into a port run and giving JAX's
features.

Run as a script, ``python tests/test_torch_port_fid.py --bridge OUT_DIR``
writes JAX's bundled ``classifier-feat`` as a port run
(``OUT_DIR/checkpoints/<step>``), which ``classifier_feature_fn(OUT_DIR)``
reads and ``utils/ckpt.py::publish_artifact`` can publish under that name."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from opticalflowdiffusion_tpu.models import resnet as jres
from opticalflowdiffusion_tpu.utils import fid as jfid
from opticalflowdiffusion_tpu_torch.models import resnet as pres
from opticalflowdiffusion_tpu_torch.utils import ckpt as pckpt
from opticalflowdiffusion_tpu_torch.utils import fid as pfid
from opticalflowdiffusion_tpu_torch.utils.weights import resnet_state_dict

ROOT = Path(__file__).resolve().parents[1]
JAX_CLASSIFIER = ROOT / "artifacts" / "classifier-feat"
RTOL = 1e-5        # features, of the reference's largest |value|
FID_RTOL = 1e-6    # frechet_distance, relative


def _stats(rng, n, d, shift=0.0):
    f = rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) * 0.3 + shift
    return pfid.feature_stats(f)


@pytest.mark.parametrize("n,d", [(400, 8), (300, 32)])
def test_frechet_distance_matches_scipy(n, d):
    rng = np.random.default_rng(d)
    a, b = _stats(rng, n, d), _stats(rng, n, d, shift=0.2)
    want = jfid.frechet_distance(*a, *b)
    assert pfid.frechet_distance(*a, *b) == pytest.approx(want, rel=FID_RTOL)
    assert pfid.frechet_distance(*a, *a) == pytest.approx(0.0, abs=1e-9)


def _singular_pair():
    rng = np.random.default_rng(3)
    return _stats(rng, 6, 16), _stats(rng, 6, 16, shift=0.5)      # rank 5 of 16


def test_frechet_distance_singular_pair():
    a, b = _singular_pair()
    assert np.linalg.matrix_rank(a[1]) < 16
    want = jfid.frechet_distance(*a, *b)
    assert pfid.frechet_distance(*a, *b) == pytest.approx(want, rel=FID_RTOL)


def test_frechet_distance_eps_retry(monkeypatch):
    """When the first square root is not finite both sides retry with eps on
    the diagonals (forced here: scipy's ``sqrtm`` and the port's trace give
    NaN on their first call)."""
    a, b = _singular_pair()

    def first_nan(fn, nan):
        calls = []

        def wrapped(m, *args, **kw):
            calls.append(1)
            return nan(m) if len(calls) == 1 else fn(m, *args, **kw)
        return wrapped, calls

    sqrtm, jcalls = first_nan(scipy.linalg.sqrtm, lambda m: np.full_like(m, np.nan))
    monkeypatch.setattr(scipy.linalg, "sqrtm", sqrtm)
    trace, pcalls = first_nan(pfid._sqrtm_trace, lambda m: float("nan"))
    monkeypatch.setattr(pfid, "_sqrtm_trace", trace)
    want = jfid.frechet_distance(*a, *b, eps=1e-3)
    got = pfid.frechet_distance(*a, *b, eps=1e-3)
    assert len(jcalls) == len(pcalls) == 2
    assert got == pytest.approx(want, rel=FID_RTOL)
    assert got != pytest.approx(jfid.frechet_distance(*a, *b), rel=1e-4)   # eps counted


def test_bank_is_jaxs_draw():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    with np.load(pfid.BANK) as bank:
        np.testing.assert_array_equal(bank["w1"], np.asarray(
            jax.random.normal(k1, (5, 5, 3, 32)) * 0.2))
        np.testing.assert_array_equal(bank["w2"], np.asarray(
            jax.random.normal(k2, (5, 5, 32, 64)) * 0.2))
    with pytest.raises(ValueError, match="seed 0 and dim 64"):
        pfid.default_feature_fn(dim=32, device="cpu")


def _close(got, want, rtol=RTOL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale, msg


@pytest.mark.parametrize("channels,side", [(3, 16), (1, 15), (2, 12), (4, 9)])
def test_default_feature_fn_matches_jax(channels, side):
    x = np.random.default_rng(channels).random((3, side, side, channels)).astype(np.float32)
    _close(pfid.default_feature_fn(device="cpu")(x), jfid.default_feature_fn()(jnp.asarray(x)),
           msg=f"{channels} channels")


@pytest.fixture(scope="module")
def classifier_tree():
    """A JAX Classifier's ResNet18 params with BatchNorm statistics drawn
    away from their initial values."""
    rng = np.random.default_rng(4)
    v = jax.device_get(jres.ResNet18().init(jax.random.PRNGKey(5),
                                            np.zeros((1, 32, 32, 3), np.float32), train=False))
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v["batch_stats"])
    return {"net": v["params"], "batch_stats": stats}


@pytest.mark.parametrize("channels", [3, 1])
def test_classifier_feature_fn_matches_jax(classifier_tree, channels):
    """64x64 inputs resized to 32 (``jax.image.resize``'s antialiased
    bilinear); the source a state dict and a port checkpoint."""
    x = np.random.default_rng(6).random((2, 64, 64, channels)).astype(np.float32)
    want = jfid.classifier_feature_fn(classifier_tree)(jnp.asarray(x))
    sd = resnet_state_dict(classifier_tree)
    for source in (sd, {"module": sd}):
        _close(pfid.classifier_feature_fn(source, device="cpu")(x), want)


def test_auto_feature_fn_sources_and_fid_between(classifier_tree, tmp_path, monkeypatch):
    """Without a resolvable artifact: a warning naming the failure and the
    bank ('randconv'); with the published port run: the classifier.  The
    Frechet distance through each feature function equals JAX's."""
    monkeypatch.setenv("OFD_ARTIFACT_ROOT", str(tmp_path / "store"))
    with pytest.warns(UserWarning, match="frechet_randconv"):
        fn, src = pfid.auto_feature_fn("no-such-artifact", device="cpu")
    assert src == "randconv"
    rng = np.random.default_rng(7)
    real = rng.random((12, 16, 16, 3)).astype(np.float32)
    fake = np.clip(real + 0.1 * rng.standard_normal(real.shape), 0, 1).astype(np.float32)
    want = jfid.fid_between(real, fake, jfid.default_feature_fn())
    assert pfid.fid_between(real, fake, fn) == pytest.approx(want, rel=1e-4)
    run = tmp_path / "run" / "checkpoints" / "7"
    run.mkdir(parents=True)
    torch.save({"step": 7, "module": resnet_state_dict(classifier_tree)}, run / "state.pt")
    pckpt.publish_artifact("classifier-feat", run.parent)
    fn, src = pfid.auto_feature_fn(device="cpu")
    assert src == "classifier"
    want = jfid.fid_between(real, fake, jfid.classifier_feature_fn(classifier_tree))
    assert pfid.fid_between(real, fake, fn) == pytest.approx(want, rel=1e-4)


# ------------------------------------------------------ the bundled artifact
def jax_classifier_artifact():
    """(JAX's bundled classifier-feat params {"net", "batch_stats"}, its
    step), restored with orbax."""
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(JAX_CLASSIFIER.absolute())
    try:
        step = mgr.latest_step()
        tree = mgr.restore(step, args=ocp.args.StandardRestore())
    finally:
        mgr.close()
    return tree["params"], step


def write_classifier_run(run_dir) -> Path:
    """JAX's bundled classifier-feat artifact as a port run directory."""
    params, step = jax_classifier_artifact()
    ck = Path(run_dir) / "checkpoints" / str(step)
    ck.mkdir(parents=True, exist_ok=True)
    torch.save({"step": int(step), "module": resnet_state_dict(params)}, ck / "state.pt")
    return Path(run_dir)


def test_bundled_orbax_artifact_raises_naming_its_bridge(monkeypatch, tmp_path):
    monkeypatch.setenv("OFD_ARTIFACT_ROOT", str(tmp_path))
    with pytest.raises(ValueError, match="test_torch_port_fid.py --bridge"):
        pckpt.resolve_artifact("classifier-feat")


def test_bridged_artifact_gives_jax_features(tmp_path):
    """JAX's trained classifier, bridged into a port run, gives JAX's
    features (and so its Frechet values) on a batch of 48x48 images."""
    run = write_classifier_run(tmp_path / "run")
    x = np.random.default_rng(8).random((3, 48, 48, 3)).astype(np.float32)
    params, _ = jax_classifier_artifact()
    want = jfid.classifier_feature_fn(params)(jnp.asarray(x))
    got = pfid.classifier_feature_fn(str(run), device="cpu")(x)
    _close(got, want)
    assert pres.ResNet18().load_state_dict(pckpt.load_artifact(str(run))) is not None


if __name__ == "__main__":
    # python tests/test_torch_port_fid.py --bridge OUT_DIR
    if len(sys.argv) != 3 or sys.argv[1] != "--bridge":
        sys.exit(__doc__)
    print(write_classifier_run(sys.argv[2]))
