"""The port stands alone: no module of it, and neither of the scripts that
run it on the card (chip_smoke.py, chip_train_spread.py), imports JAX,
flax, yaml, cv2, PIL or the JAX package.  And its flagship config holds the
values that the JAX config composes."""

import ast
from pathlib import Path

import pytest

from opticalflowdiffusion_tpu.config import compose
from opticalflowdiffusion_tpu_torch.config import FLAGSHIP, FLAGSHIP_DATA

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
