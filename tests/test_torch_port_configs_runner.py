"""The entry points on FlowDiffuser's other configurations, on the CPU:
``train.py`` for each of ``--target target``, ``--target flow``,
``--noiser flow``, ``--no-diffusion`` and ``--diffusion-flow-weight 1``;
the AE chain (``--algorithm flow_pred``, then ``--latent --ae`` on that
run, then ``--resume``); ``sample.py`` with the model flags; the
Autoencoder pretraining script.  And, marked ``cuda`` (skipped where there
is no card), the splat kernel at the latent model's 16 and 17 channels bit
for bit, ``permute_warp`` on the card against the CPU, and one latent train
step with the kernels against the plain versions.  This file imports no JAX,
so the card's tests run with ``--noconftest``."""

import json

import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu_torch import kernels
from opticalflowdiffusion_tpu_torch import sample as sample_entry
from opticalflowdiffusion_tpu_torch import train as train_entry
from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import FlowDiffuser
from opticalflowdiffusion_tpu_torch.config import FLAGSHIP
from opticalflowdiffusion_tpu_torch.ops import splat as psplat
from opticalflowdiffusion_tpu_torch.ops.warp import permute_warp
from opticalflowdiffusion_tpu_torch.training.ae_pretrain import train_ae
from opticalflowdiffusion_tpu_torch.utils.ckpt import load_params_from_run

TINY = ["--device", "cpu", "--image-size", "16", "--unet-dim", "8", "--batch", "2",
        "--val-batch", "2", "--sampling-timesteps", "2"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _train(capsys, args):
    train_entry.main(TINY + args)
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("flags,fields", [
    (["--target", "target"], {"target": "target"}),
    (["--target", "flow"], {"target": "flow"}),
    (["--noiser", "flow"], {"noiser": "flow"}),
    (["--no-diffusion", "--flow-weight", "0.5"], {"is_diffusion": False, "flow_weight": 0.5}),
    (["--diffusion-flow-weight", "1"], {"diffusion_flow_weight": 1.0}),
])
def test_train_entry_point_configs(tmp_path, capsys, flags, fields):
    """Two steps of each configuration: a finite loss, a validation with
    its metrics, a checkpoint, and the config fields the flags set."""
    out = _train(capsys, ["--steps", "2", "--out", str(tmp_path)] + flags)
    assert out["step"] == 2 and out["checkpoints"] == [2]
    assert all(out[k] == v for k, v in fields.items())
    assert np.isfinite(out["train"]["train/loss"])
    assert np.isfinite(out["val"]["val/epe"]) and "val/mse" in out["val"]
    assert ("val/last_step" in out["val"]) == (out["is_diffusion"] and out["target"] != "flow")


def test_ae_chain_train_latent_resume(tmp_path, capsys):
    """FlowPred trains the Autoencoder and checkpoints it under ``ae.``; the
    latent joint model loads it frozen through ``--ae`` and trains; a
    ``--resume`` of the latent run continues from its checkpoint with the
    same Autoencoder."""
    ae_dir, lat_dir = tmp_path / "ae", tmp_path / "latent"
    fp = _train(capsys, ["--algorithm", "flow_pred", "--latent-dim", "4", "--steps", "2",
                         "--out", str(ae_dir)])
    assert fp["algorithm"] == "flow_pred" and fp["checkpoints"] == [2]
    assert np.isfinite(fp["train"]["train/loss"]) and np.isfinite(fp["val"]["val/loss"])
    ae = load_params_from_run(ae_dir, prefix="ae.")
    assert ae and all(k.startswith(("model_enc.", "model_dec.")) for k in ae)
    latent = ["--latent", "--ae", str(ae_dir), "--latent-dim", "4", "--out", str(lat_dir)]
    first = _train(capsys, latent + ["--steps", "2"])
    assert first["latent"] and first["ae"] == str(ae_dir) and first["checkpoints"] == [2]
    assert np.isfinite(first["train"]["train/loss"]) and np.isfinite(first["val"]["val/mse"])
    resumed = _train(capsys, latent + ["--steps", "3", "--resume"])
    assert resumed["start_step"] == 2 and resumed["step"] == 3
    assert resumed["checkpoints"] == [2, 3]
    # the latent run's checkpoints hold the diffuser only; its AE is the run's
    exp = train_entry.build(3, device="cpu", image_size=16, unet_dim=8, out=str(lat_dir),
                            latent=True, ae=str(ae_dir), latent_dim=4)
    assert all(torch.equal(v, ae[k]) for k, v in exp.algorithm.ae.state_dict().items())
    assert not any(p.requires_grad for p in exp.algorithm.ae.parameters())
    assert not any(k.startswith("ae.") for k in load_params_from_run(lat_dir))


@pytest.mark.parametrize("flags,shape", [
    (["--target", "flow"], [2, 3, 16, 16]),
    (["--target", "target"], [2, 3, 16, 16]),
    (["--noiser", "flow"], [2, 3, 16, 16]),
    (["--no-diffusion"], [2, 3, 16, 16]),
    (["--latent", "--latent-dim", "4"], [2, 4, 16, 16]),
])
def test_sample_entry_point_model_flags(capsys, flags, shape):
    sample_entry.main(["--device", "cpu", "--batch", "2", "--sampling-timesteps", "2",
                       "--height", "16", "--width", "16"] + flags)
    out = json.loads(capsys.readouterr().out)
    assert out["samples_shape"] == shape and out["flow_shape"] == [2, 2, 16, 16]
    assert out["finite_values_finite"] and out["frames_per_s"] > 0
    assert out["denoise_steps"] == (1 if "--no-diffusion" in flags else 2)


def test_ae_pretrain_writes_what_latent_mode_reads(tmp_path):
    res = train_ae(steps=2, image_size=16, batch=2, latent_dim=4, dataset_size=8,
                   out_dir=str(tmp_path), device="cpu")
    assert res["steps"] == 2 and res["latent_dim"] == 4
    assert all(np.isfinite(res[k]) for k in ("recon_mse", "recon_mse_init", "identity_mse"))
    cfg = FLAGSHIP.__class__(image_size=16, unet_dim=8, precision="float32", latent=True,
                             latent_dim=4, ae=str(tmp_path))
    algo = FlowDiffuser(cfg, device="cpu")
    ae = load_params_from_run(tmp_path, prefix="ae.")
    assert all(torch.equal(v, ae[k]) for k, v in algo.ae.state_dict().items())


def test_flow_diffuser_refuses_unknown_settings():
    for fields in (dict(target="image"), dict(noiser="pixel")):
        with pytest.raises(ValueError):
            FlowDiffuser(FLAGSHIP.__class__(unet_dim=8, **fields), device="cpu")


# ------------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [16, 17])
@pytest.mark.parametrize("scale", [1, 2, 4, 8, 16])
def test_splat_kernel_at_latent_channels_is_bitwise_on_card(cuda_device, dtype, C, scale):
    """The latent model's pyramid splats (16 latent channels, 17 with the
    warp's weight channel, at 128x128 and scales 1-16): the kernel equals
    splat_fixed_plain bit for bit (values as integers, and the hole mask),
    two launches alike."""
    g = torch.Generator(device="cuda").manual_seed(C * 100 + scale)
    v = (2 * torch.rand(2, C, 128, 128, generator=g, device="cuda") - 1).to(dtype)
    flow = 4 * torch.randn(2, 2, 128, 128, generator=g, device="cuda")
    n0 = kernels.SPLAT.launches
    out, mask = psplat.splat_fwd(v, flow, scale, (0, 0))
    again, mask2 = psplat.splat_fwd(v, flow, scale, (0, 0))
    want, wmask = psplat.splat_fixed_plain(v, flow, scale, (0, 0))
    torch.cuda.synchronize()
    assert kernels.SPLAT.launches == n0 + 2
    assert torch.equal(_bits(out), _bits(want)) and torch.equal(mask, wmask)
    assert torch.equal(_bits(out), _bits(again)) and torch.equal(mask, mask2)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.0, 1e-3, 0.3, 30.0])
def test_permute_warp_on_card_equals_cpu(cuda_device, sigma):
    """The same permutation on the card as on the CPU (the key in the same
    float32 operations; a stable sort on both)."""
    g = torch.Generator().manual_seed(int(sigma * 1000) + 1)
    img = torch.randn(2, 5, 128, 96, generator=g)
    flow = torch.randn(2, 2, 128, 96, generator=g) * sigma
    want = permute_warp(img, flow)
    got = permute_warp(img.to(cuda_device), flow.to(cuda_device)).cpu()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_latent_train_step_kernels_vs_plain_on_card(cuda_device):
    """One train step of the latent joint model (128x128 b16, bf16, the
    Autoencoder drawn from the seed) with every kernel against the same
    step with every plain version: chip_smoke.py's check and pins
    (``config_step_vs_plain``, ``TOL_TRAIN_CONFIGS``)."""
    import chip_smoke as cs

    algo = cs.config_algo(dict(latent=True))
    loss_rel, grad_rel = cs.config_step_vs_plain(algo, "latent", cs.train_batch())
    tol = cs.TOL_TRAIN_CONFIGS["latent"]
    assert loss_rel <= tol[0] and grad_rel <= tol[1]
