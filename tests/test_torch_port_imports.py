"""The port stands alone: no module of it, and neither of the scripts that
run it on the card (chip_smoke.py, chip_train_spread.py), imports JAX,
flax, yaml, cv2, PIL or the JAX package.  And its flagship config holds the
values that the JAX config composes."""

import ast
from pathlib import Path

import pytest

from opticalflowdiffusion_tpu.config import compose
from opticalflowdiffusion_tpu_torch.config import (
    ANIMATION, ARTIFICIAL_VIDEO, FLAGSHIP, FLAGSHIP_DATA, FLOW_COMPLETER, FRAME_GENERATOR,
    MATRIX_FLOW_ALGO,
)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "yaml", "opticalflowdiffusion_tpu", "cv2", "PIL"}
PORT_FILES = sorted((ROOT / "opticalflowdiffusion_tpu_torch").rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "chip_train_spread.py")
]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0]
            if name in ("import_module", "__import__") and isinstance(arg, ast.Constant):
                yield str(arg.value).split(".")[0]


def test_port_files_exist():
    assert len(PORT_FILES) > 15
    assert all(p.exists() for p in PORT_FILES)


def test_configs_modules_are_checked():
    """The modules of FlowDiffuser's other configurations and latent mode
    are among the files checked above."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for mod in ("algorithms/flow_pred.py", "models/autoencoder.py",
                "training/ae_pretrain.py", "training/__init__.py", "ops/warp.py",
                "experiments/matrix_flow.py", "utils/ckpt.py"):
        assert f"opticalflowdiffusion_tpu_torch/{mod}" in names, mod


def test_data_and_runner_modules_are_checked():
    """The readers, their host helper's bindings, the loader and the
    runner's modules are among the files checked above."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for mod in ("data/png.py", "data/resize.py", "data/host.py", "data/flow_io.py",
                "data/sintel.py", "data/flying_chairs.py", "data/kitti_single.py",
                "data/fixtures.py", "data/loader.py", "data/__init__.py",
                "utils/import_torch_ckpt.py", "utils/logging.py", "experiments/base.py"):
        assert f"opticalflowdiffusion_tpu_torch/{mod}" in names, mod


def test_family_modules_are_checked():
    """MatrixFlow's and the animation family's modules are among the files
    checked above."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for mod in ("algorithms/matrix_flow.py", "algorithms/animation.py",
                "data/artificial_video.py", "experiments/animation.py",
                "training/parity_families.py", "ops/filters.py", "utils/weights.py"):
        assert f"opticalflowdiffusion_tpu_torch/{mod}" in names, mod


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(set(_imported_roots(tree)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_flagship_config_matches_jax_compose():
    cfg = compose(["experiment=matrix_flow", "algorithm=flow_diffuser",
                   "dataset=artificial"])
    algo, data = cfg.algorithm, cfg.dataset
    for field in ("image_size", "latent_dim", "flow_max", "latent_max", "is_diffusion",
                  "latent", "timesteps", "sampling_timesteps", "target", "noiser",
                  "zero_init"):
        assert getattr(FLAGSHIP, field) == algo[field], field
    # read with these defaults by the JAX FlowDiffuser (cfg.get)
    assert FLAGSHIP.unet_dim == algo.get("unet_dim", 64)
    assert FLAGSHIP.sampler == algo.get("sampler", "auto")
    assert FLAGSHIP.precision == cfg.runtime.precision
    for field in ("size", "num_channels", "shape", "bg"):
        assert getattr(FLAGSHIP_DATA, field) == data[field], field
    assert FLAGSHIP_DATA.seed == data.get("seed")
    assert FLAGSHIP_DATA.max_motion == data.get("max_motion", 1)
    # the port draws its data at the model's resolution
    assert FLAGSHIP_DATA.image_size == algo.image_size


@pytest.mark.parametrize("algorithm,port", [
    ("matrix_flow", MATRIX_FLOW_ALGO), ("frame_generator", FRAME_GENERATOR),
    ("flow_completer", FLOW_COMPLETER),
])
def test_family_configs_match_jax_compose(algorithm, port):
    """Every key of the family's yamls holds JAX's composed value (the
    port's ``cols`` and ``timesteps`` are JAX's ``cfg.get`` defaults)."""
    experiment = "matrix_flow" if algorithm == "matrix_flow" else "animation"
    dataset = "artificial" if algorithm == "matrix_flow" else "artificial_video"
    cfg = compose([f"experiment={experiment}", f"algorithm={algorithm}", f"dataset={dataset}"])
    algo = cfg.algorithm
    for key, value in dict(algo).items():
        if key != "name":
            assert getattr(port, key) == value, key
    assert port.precision == cfg.runtime.precision
    if algorithm == "matrix_flow":
        assert port.cols is None and algo.get("cols") is None
    if algorithm == "frame_generator":
        assert port.timesteps == algo.get("timesteps", 1000)
        assert port.sampling_timesteps == algo.get("sampling_timesteps")


def test_animation_experiment_config_matches_jax_compose():
    """experiment/animation.yaml over base.yaml, and the video dataset."""
    cfg = compose(["experiment=animation", "algorithm=frame_generator",
                   "dataset=artificial_video"])
    exp, data = cfg.experiment, cfg.dataset
    assert ANIMATION.batch_size == exp.training.data.batch_size
    assert ANIMATION.clipping == exp.training.get("clipping")
    assert ANIMATION.check_interval == exp.validation.check_interval
    assert ANIMATION.limit_batch == exp.validation.limit_batch
    assert ANIMATION.val_batch_size == exp.validation.data.batch_size
    assert ANIMATION.val_shuffle == exp.validation.data.shuffle
    assert ANIMATION.every_n_train_steps == exp.training.checkpointing.every_n_train_steps
    assert ANIMATION.num_workers == exp.training.data.num_workers
    for key in ("image_size", "size", "val_length", "max_motion"):
        assert getattr(ARTIFICIAL_VIDEO, key) == data[key], key
