"""The port's initial weights are flax's (``models/unet.py::init_weights``):
kernels from ``lecun_normal`` (a normal truncated at +-2, rescaled to a
variance of 1 / fan_in: no entry beyond 2.2737 / sqrt(fan_in)), biases 0,
norm gains 1, at every entry point; so a zero-initialised model outputs
exactly 0 on any batch, as JAX's does.  The draw's quantiles are held to
flax's own (one leaf of 589,824 entries each side: the variance within 1%
of 1 / fan_in, the quantiles within 0.02 / sqrt(fan_in))."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from opticalflowdiffusion_tpu.algorithms.animation import FlowCompleter as JFlowCompleter
from opticalflowdiffusion_tpu.algorithms.animation import FrameGenerator as JFrameGenerator
from opticalflowdiffusion_tpu.algorithms.flow_diffuser import FlowDiffuser as JFlowDiffuser
from opticalflowdiffusion_tpu.algorithms.flow_learner import FlowLearner as JFlowLearner
from opticalflowdiffusion_tpu.algorithms.flow_pred import FlowPred as JFlowPred
from opticalflowdiffusion_tpu.algorithms.matrix_flow import MatrixFlow as JMatrixFlow
from opticalflowdiffusion_tpu.algorithms.pwc_learner import PWCLearner as JPWCLearner
from opticalflowdiffusion_tpu.config import compose
from opticalflowdiffusion_tpu.models.unet import Unet as JUnet
from opticalflowdiffusion_tpu_torch import config as C
from opticalflowdiffusion_tpu_torch.algorithms.animation import FlowCompleter, FrameGenerator
from opticalflowdiffusion_tpu_torch.algorithms.flow_diffuser import FlowDiffuser
from opticalflowdiffusion_tpu_torch.algorithms.flow_learner import FlowLearner
from opticalflowdiffusion_tpu_torch.algorithms.flow_pred import FlowPred
from opticalflowdiffusion_tpu_torch.algorithms.matrix_flow import MatrixFlow
from opticalflowdiffusion_tpu_torch.algorithms.pwc_learner import PWCLearner
from opticalflowdiffusion_tpu_torch.models.unet import Unet, init_weights, lecun_normal
from opticalflowdiffusion_tpu_torch.utils import weights as W

BOUND = 2.0 / 0.87962566103423978          # 2.27370...


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _zeros_pair(side):
    return (np.zeros((2, side, side, 3), np.float32), np.zeros((2, side, side, 3), np.float32),
            np.zeros((2, side, side, 2), np.float32))


def _video(side):
    return (np.zeros((2, side, side, 8), np.float32),)


# name: (port class, port config, JAX composition, JAX batch for ``init``,
#        the weights table taking JAX's tree to the port's state_dict)
ENTRY_POINTS = {
    "flow_diffuser": (FlowDiffuser, dataclasses.replace(C.FLAGSHIP, unet_dim=8, image_size=16),
                      ["algorithm=flow_diffuser", "algorithm.image_size=16",
                       "+algorithm.unet_dim=8"], _zeros_pair(16), W.flow_diffuser_state_dict),
    "flow_pred": (FlowPred, C.FLOW_PRED, ["algorithm=flow_pred"], _zeros_pair(32),
                  lambda p: W.autoencoder_state_dict(p, "ae.")),
    "flow_learner": (FlowLearner, C.FLOW_LEARNER, ["algorithm=flow_learner"], _zeros_pair(16),
                     W.flow_learner_state_dict),
    "flow_learner_filter": (FlowLearner, dataclasses.replace(C.FLOW_LEARNER, radius=3,
                                                             flow_max=None, c2f=True),
                            ["algorithm=flow_learner", "~algorithm.flow_max",
                             "+algorithm.radius=3", "+algorithm.c2f=true"], _zeros_pair(16),
                            W.flow_learner_state_dict),
    "matrix_flow": (MatrixFlow, C.MATRIX_FLOW_ALGO, ["algorithm=matrix_flow"], _zeros_pair(16),
                    W.params_from_jax),
    "frame_generator": (FrameGenerator, C.FRAME_GENERATOR,
                        ["experiment=animation", "dataset=artificial_video",
                         "algorithm=frame_generator"], _video(16), W.params_from_jax),
    "flow_completer": (FlowCompleter, C.FLOW_COMPLETER,
                       ["experiment=animation", "dataset=artificial_video",
                        "algorithm=flow_completer"], _video(16), W.flow_completer_state_dict),
    "pwc_learner": (PWCLearner, C.PWC_LEARNER, ["algorithm=pwc_learner"], _zeros_pair(64),
                    W.pwc_state_dict),
}
JAX_ALGOS = {"flow_diffuser": JFlowDiffuser, "flow_pred": JFlowPred,
             "flow_learner": JFlowLearner, "flow_learner_filter": JFlowLearner,
             "matrix_flow": JMatrixFlow, "frame_generator": JFrameGenerator,
             "flow_completer": JFlowCompleter, "pwc_learner": JPWCLearner}


def _fan_in_tree(params):
    """JAX's tree with every kernel leaf filled with flax's fan_in for it
    (the kernel's size over all axes but the last, the output one) and
    every other leaf with 0: through the weights table, the fan_in of each
    port entry."""
    def fill(path, leaf):
        kernel = str(path[-1].key) == "kernel"
        return np.full(leaf.shape, np.prod(leaf.shape[:-1]) if kernel else 0, np.float32)

    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_start_from_flax_defaults(name):
    """Each algorithm's fresh module against JAX's ``init`` of the same
    algorithm, leaf by leaf through the weights table: every port parameter
    has a JAX leaf of its shape; where JAX's leaf is constant (biases 0,
    norm gains 1, a zeroed output conv, FlowCompleter's null embedding)
    the port's equals it; every kernel lies within flax's truncation at
    JAX's fan_in, and on a leaf of 200 entries or more its standard
    deviation times sqrt(fan_in) is within 0.25 of 1, as JAX's is."""
    cls, cfg, over, batch, table = ENTRY_POINTS[name]
    over = ["experiment=matrix_flow", "dataset=artificial"] + over if \
        not over[0].startswith("experiment") else over
    jalgo = JAX_ALGOS[name](compose(over).algorithm)
    params = jax.device_get(jalgo.init(jax.random.PRNGKey(0),
                                       tuple(map(jnp.asarray, batch))).params)
    want, fan = table(params), table(_fan_in_tree(params))
    algo = cls(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    got = dict(algo.module.named_parameters())
    assert set(got) == set(want)
    kinds = set()
    for key, p in got.items():
        p, w, f = p.detach(), want[key], fan[key]
        assert p.shape == w.shape, key
        if bool((w == w.flatten()[0]).all()):
            kinds.add("constant")
            assert torch.equal(p, w), key
        elif float(f.flatten()[0]) > 0:
            kinds.add("kernel")
            scale = math.sqrt(float(f.flatten()[0]))
            assert float(w.abs().max()) * scale <= BOUND + 1e-5, key    # JAX's own draw
            assert float(p.abs().max()) * scale <= BOUND + 1e-5, key
            if p.numel() >= 200:
                assert abs(float(w.std()) * scale - 1.0) < 0.25, key
                assert abs(float(p.std()) * scale - 1.0) < 0.25, key
        else:                                   # the Fourier embedding's N(0, 1)
            kinds.add("other")
            assert p.numel() < 200 or abs(float(p.std()) / float(w.std()) - 1.0) < 0.25, key
    assert {"kernel", "constant"} <= kinds


def test_lecun_normal_matches_flax():
    """The port's draw and flax's on a 3x3x256x256 kernel: the bound, the
    variance and the quantiles."""
    shape, fan_in = (256, 256, 3, 3), 256 * 9
    port = lecun_normal(shape, fan_in, torch.Generator().manual_seed(0)).numpy().ravel()
    flax = np.asarray(fnn.initializers.lecun_normal()(jax.random.PRNGKey(0), (3, 3, 256, 256)))
    flax = flax.ravel()
    scale = math.sqrt(fan_in)
    assert np.abs(port).max() * scale <= BOUND + 1e-5
    assert np.abs(flax).max() * scale <= BOUND + 1e-5
    assert abs(port.var() * fan_in - 1.0) < 0.01
    assert abs(flax.var() * fan_in - 1.0) < 0.01
    q = (0.001, 0.01, 0.1, 0.5, 0.9, 0.99, 0.999)
    np.testing.assert_allclose(np.quantile(port, q) * scale, np.quantile(flax, q) * scale,
                               atol=0.02)


def test_zero_initialised_model_outputs_zero_as_jax():
    """A fresh UNet with its output conv zeroed outputs exactly 0 on a
    random batch, in the port as in JAX (biases 0, so nothing passes the
    zeroed conv)."""
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 6)).astype(np.float32)
    jm = JUnet(8, out_dim=3, channels=6, dim_mults=(1, 2), time_in=False, zero_init_final=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    net = init_weights(Unet(8, out_dim=3, channels=6, dim_mults=(1, 2), time_in=False,
                            zero_init_final=True), torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert not want.any() and not got.numpy().any()
    algo = FlowLearner(dataclasses.replace(C.FLOW_LEARNER, image_size=16), device="cpu")
    with torch.no_grad():
        out = algo.module(torch.randn(2, 6, 16, 16))
    assert torch.equal(out, torch.zeros_like(out))
