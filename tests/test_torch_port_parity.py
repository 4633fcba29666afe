"""Port vs JAX for the parity harness (``training/parity.py``) and the image
writer it uses (``utils/visualization.py``), on the CPU: ``_w1``;
``_eval`` against JAX's ``_eval`` on the same stub validation step (fixed
numpy metrics and artifacts, so no model runs); a tiny ``run_parity``
(2 steps, 8x8 frames, the ``joint`` and ``learner`` stages) whose JSON
carries JAX's keys per stage (the Frechet ones under the port's feature
source); the recorded JAX bars
against ``parity/parity_r05.json``; the zlib PNG against the one JAX
writes with PIL, both decoded by PIL; the data of the latent stage's
AE pretraining against JAX's; and JAX's own parity Autoencoder
(``parity/ae_pretrain``), whose encoder gives one latent for every parity
frame.

Run as a script, ``python tests/test_torch_port_parity.py OUT`` writes
JAX's parity Autoencoder as a port run under ``OUT/jax_ae`` and trains the
latent parity stage on it at the stage's own settings (``--device``,
default cpu; ``--steps`` for the stage, default JAX's 2000)."""

import dataclasses
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from opticalflowdiffusion_tpu.config import Config
from opticalflowdiffusion_tpu.data.artificial import ArtificialDataset as JArtificialDataset
from opticalflowdiffusion_tpu.training import parity as jparity
from opticalflowdiffusion_tpu.utils import visualization as jviz
from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import FlowDiffuser
from opticalflowdiffusion_tpu_torch.config import FLAGSHIP, FLAGSHIP_DATA
from opticalflowdiffusion_tpu_torch.data.artificial import ArtificialDataset
from opticalflowdiffusion_tpu_torch.models.autoencoder import Autoencoder
from opticalflowdiffusion_tpu_torch.models.unet import init_weights
from opticalflowdiffusion_tpu_torch.training import parity
from opticalflowdiffusion_tpu_torch.utils.weights import autoencoder_state_dict
from opticalflowdiffusion_tpu_torch.training.ae_pretrain import train_ae
from opticalflowdiffusion_tpu_torch.utils import visualization as viz

ROOT = Path(__file__).resolve().parents[1]
R05 = json.loads((ROOT / "parity" / "parity_r05.json").read_text())


def test_w1_matches_jax():
    rng = np.random.default_rng(0)
    for a, b in ((rng.standard_normal(300), rng.uniform(0, 2, 700)),
                 (rng.standard_normal(60000), rng.standard_normal(100)),
                 (np.zeros(0), np.ones(4))):
        got, want = parity._w1(a, b), jparity._w1(a, b)
        assert (np.isnan(got) and np.isnan(want)) or abs(got - want) <= 1e-12


def _stub_batches(n=3, B=2, H=6, W=5, seed=1):
    """NHWC numpy batches and the fixed (metrics, artifacts) of each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        flow = rng.integers(-1, 2, (B, H, W, 2)).astype(np.float32)
        flow[:, : H // 2] = 0.0                           # a static half
        batch = (rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
                 rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32), flow)
        metrics = {k: float(rng.uniform(0, 1)) for k in
                   ("val/epe", "val/mse", "val/loss", "val/last_step_epe", "val/ideal_loss",
                    "val/other")}
        arts = {"p_flows": (rng.standard_normal((B, H, W, 2)) * 0.8).astype(np.float32),
                "last_step_flow": rng.standard_normal((B, H, W, 2)).astype(np.float32)}
        out.append((batch, metrics, arts))
    return out


def test_eval_matches_jax():
    """Both ``_eval``s on the same stub outputs (JAX's artifacts NHWC, the
    port's NCHW tensors): every metric to 1e-9, the first batch's artifacts."""
    stubs = _stub_batches()
    jstate = types.SimpleNamespace(params=None)
    calls = iter(range(len(stubs)))

    def jstep(params, batch, rng):
        _, m, a = stubs[next(calls)]
        return m, a

    want, _, _ = jparity._eval(None, jstate, [b for b, _, _ in stubs], jax.random.PRNGKey(0),
                               n_batches=len(stubs), val_step=jstep)
    pcalls = iter(range(len(stubs)))

    def pstep(batch, generator):
        i = next(pcalls)
        np.testing.assert_array_equal(batch[2].permute(0, 2, 3, 1).numpy(), stubs[i][0][2])
        nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
        return stubs[i][1], {k: nchw(v) for k, v in stubs[i][2].items()}

    algo = types.SimpleNamespace(device=torch.device("cpu"))
    got, arts0, batch0 = parity._eval(algo, [b for b, _, _ in stubs], None,
                                      n_batches=len(stubs), val_step=pstep)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= 1e-9 * max(1.0, abs(w)), k
    assert batch0 is stubs[0][0]
    np.testing.assert_array_equal(arts0["p_flows"].permute(0, 2, 3, 1).numpy(),
                                  stubs[0][2]["p_flows"])


def test_jax_bars_are_the_recorded_results():
    """``JAX_BARS`` holds parity_r05.json's numbers to 6 significant digits."""
    for key, bar in parity.JAX_BARS.items():
        rec = R05[key]
        assert bar["steps"] == rec["steps"], key
        if key == "ae_pretrain":
            for k in ("recon_mse", "recon_mse_init", "identity_mse"):
                np.testing.assert_allclose(bar[k], rec[k], rtol=5e-6, err_msg=key)
            continue
        for phase in ("init", "final"):
            for k, v in bar[phase].items():
                np.testing.assert_allclose(v, rec[phase][k], rtol=5e-6, atol=1e-12,
                                           err_msg=f"{key} {phase} {k}")


def _without_frechet(keys):
    return {k for k in keys if not k.startswith(("frechet_", "render_"))}


def _frechet_from(keys, src):
    """JAX's Frechet keys (``frechet_classifier*``) with the port's feature
    source: the random-conv bank here, where ``classifier-feat`` is JAX's
    orbax checkpoint, which the port does not read."""
    return {k.replace("frechet_classifier", f"frechet_{src}") for k in keys}


def test_tiny_run_parity_on_cpu(tmp_path):
    """Two steps each of the joint and learner stages at 8x8 on the CPU: the
    JSON has JAX's keys per stage and in init/final (the joint stage's final
    Frechet rows under the random-conv source, which the port falls back to
    here), the bars, the learner's oracles and its images.  Validation
    batches of 4 give the Frechet floor's halves 2 images each (a covariance
    needs two)."""
    res = parity.run_parity(
        out_dir=str(tmp_path), diffuser_steps=2, learner_steps=2, batch=2, image_size=8,
        dataset_size=32, sampling_timesteps=2, stages=("joint", "learner"), device="cpu",
        val_batch=4, val_batches=1, init_batches=1, levels=(1, 2), unet_dim=8, log_every=1)
    saved = json.loads((tmp_path / "parity.json").read_text())
    assert saved.keys() == res.keys() == {"device", "n_devices", "bars", "flow_diffuser",
                                          "flow_learner"}
    for key in ("flow_diffuser", "flow_learner"):
        assert saved[key].keys() == R05[key].keys(), key
        for phase in ("init", "final"):
            want = (_frechet_from(R05[key][phase].keys(), "randconv")
                    if (key, phase) == ("flow_diffuser", "final")
                    else _without_frechet(R05[key][phase].keys()))
            assert saved[key][phase].keys() == want, (key, phase)
            assert all(np.isfinite(v) or k.startswith("dist_w1_") for k, v in
                       saved[key][phase].items()), key
        assert saved[key]["steps"] == 2 and [s for s, _ in saved[key]["loss_curve"]] == [1, 2]
        assert set(saved["bars"][key]) >= {"init zero_flow_epe", "init moving_frac_gt"}
    assert saved["flow_learner"]["loss_oracles"].keys() == R05["flow_learner"][
        "loss_oracles"].keys()
    for name in saved["flow_learner"]["visuals"]:
        assert Image.open(tmp_path / name).size[0] > 0
    # the zero-initialised models start at zero flow: their EPE is the zero-flow EPE
    for key in ("flow_diffuser", "flow_learner"):
        init = saved[key]["init"]
        assert abs(init["val/epe"] - init["zero_flow_epe"]) <= 1e-6 * init["zero_flow_epe"]


@pytest.mark.parametrize("shape", [(5, 7, 3), (3, 6, 4, 3), (4, 5, 1), (6, 4, 4)])
def test_png_matches_jax_pil(tmp_path, shape):
    """``save_image`` (zlib, no PIL) writes the pixels JAX's ``save_image``
    writes through PIL: an image, a batch as a grid, one channel as grey,
    RGBA."""
    img = np.random.default_rng(0).uniform(-0.2, 1.2, shape).astype(np.float32)
    viz.save_image(img, tmp_path / "port.png")
    jviz.save_image(img, tmp_path / "jax.png")
    got, want = (np.asarray(Image.open(tmp_path / n)) for n in ("port.png", "jax.png"))
    np.testing.assert_array_equal(got, want)


def test_visualization_helpers_match_jax():
    rng = np.random.default_rng(1)
    flow = rng.standard_normal((2, 5, 6, 2)).astype(np.float32) * 3
    flow[0, 0, 0] = np.nan
    np.testing.assert_array_equal(viz.flow_to_image(flow), jviz.flow_to_image(flow))
    imgs = rng.uniform(0, 1, (5, 4, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(viz.make_grid(imgs, nrow=2), jviz.make_grid(imgs, nrow=2))
    np.testing.assert_array_equal(viz.to_uint8(imgs), jviz.to_uint8(imgs))


def test_ae_pretrain_draws_jax_data(tmp_path):
    """The parity latent stage's AE pretraining (``train_ae``) draws the
    data JAX's ``train_ae`` draws: the identity baseline on its validation
    batch (seed + 1, 256 items, white background) equals JAX's."""
    res = train_ae(steps=1, image_size=16, batch=4, latent_dim=4, dataset_size=8, seed=3,
                   out_dir=str(tmp_path), device="cpu")
    val = JArtificialDataset(Config(dict(image_size=16, size=256, seed=4)))
    img, tgt = (np.stack([val[i][k] for i in range(4)]) for k in (0, 1))
    np.testing.assert_allclose(res["identity_mse"], float(np.mean(np.square(img - tgt))),
                               rtol=1e-6)


JAX_AE = ROOT / "parity" / "ae_pretrain" / "checkpoints"


def jax_parity_ae():
    """(JAX's parity Autoencoder params, its step), restored with orbax."""
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(JAX_AE.absolute())
    try:
        step = mgr.latest_step()
        tree = mgr.restore(step, args=ocp.args.StandardRestore())
    finally:
        mgr.close()
    return tree["params"]["ae"], step


def write_jax_ae_run(run_dir) -> Path:
    """JAX's parity Autoencoder as a port run directory: its newest
    checkpoint holds the Autoencoder under ``ae.``, as ``--ae`` reads it."""
    params, step = jax_parity_ae()
    ck = Path(run_dir) / "checkpoints" / str(step)
    ck.mkdir(parents=True, exist_ok=True)
    module = {"ae." + k: v for k, v in autoencoder_state_dict(params).items()}
    torch.save({"step": int(step), "module": module}, ck / "state.pt")
    return Path(run_dir)


def _parity_val_frames(n=16):
    """The first ``n`` items of the parity stages' dataset (32x32, 4096
    items, seed 7): their unshuffled validation batches."""
    data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=32, size=4096,
                                                 seed=7))
    items = [data[i] for i in range(n)]
    return tuple(np.stack([it[k] for it in items]) for k in range(3))


def test_jax_parity_ae_gives_one_latent_for_every_frame(tmp_path):
    """JAX's parity Autoencoder (the one behind its latent bar, val/mse 0 ->
    2.0e-4) encodes all 16 frames of the parity stages' two initial
    validation batches, and their targets, to one latent: its spread over
    frames is zero in JAX and in the port, and nearly every entry sits on
    the encoder's clamp at +-1.  So the latent stage's val/mse,
    which compares the encoded sample with the encoded target, is 0 for a
    zero-initialised model (the sample is the encoded frame itself): the
    port's latent FlowDiffuser on this AE gives exactly 0 at init."""
    from opticalflowdiffusion_tpu.models.autoencoder import Autoencoder as JAutoencoder

    params, _ = jax_parity_ae()
    img, tgt, flow = _parity_val_frames()
    jae = JAutoencoder(latent_dim=16)
    j_lat = np.asarray(jax.jit(lambda p, x: jae.apply({"params": p}, x, method=jae.encode))(
        params, np.concatenate([img, tgt])))
    assert float(j_lat.std(axis=0).max()) == 0.0
    ae = Autoencoder(16).eval()
    ae.load_state_dict(autoencoder_state_dict(params), strict=True)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        lat = ae.encode(nchw(np.concatenate([img, tgt])))
    assert float(lat.std(dim=0).max()) == 0.0
    assert float((lat.abs() == 1.0).float().mean()) >= 0.99
    # the latent stage's model at init (flax's initialisers: zero flow) on this AE
    cfg = dataclasses.replace(FLAGSHIP, image_size=32, flow_max=2.0, unet_dim=8,
                              sampling_timesteps=2, precision="float32", latent=True,
                              latent_dim=16, ae=str(write_jax_ae_run(tmp_path / "jax_ae")))
    algo = FlowDiffuser(cfg, device="cpu")
    init_weights(algo.module, torch.Generator().manual_seed(3))
    batch = tuple(nchw(a) for a in (img[:8], tgt[:8], flow[:8]))
    metrics, _ = algo.val_step(batch, torch.Generator().manual_seed(0))
    assert float(metrics["val/mse"]) == 0.0
    # the frames themselves differ: the pixel-space identity gap is not 0
    assert float(np.mean(np.square(img - tgt))) > 1e-2


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="the latent parity stage on JAX's Autoencoder")
    ap.add_argument("out")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--steps", type=int,
                    default=parity.JAX_BARS["flow_diffuser_latent"]["steps"])
    a = ap.parse_args()
    ae_dir = write_jax_ae_run(Path(a.out) / "jax_ae")
    res = parity.run_parity(out_dir=a.out, diffuser_steps=2 * a.steps, stages=("latent",),
                            device=a.device, ae_dir=str(ae_dir))
    json.dump(res, sys.stdout, indent=1)
