"""Port vs JAX for RAFT (``models/raft.py``), its correlation
(``ops/correlation.py``: ``allpairs_correlation``, ``avg_pool2d``, the
windowed lookup's plain version), the weight table
(``utils/weights.py::raft_rows``), the flow pretraining's loss and
optimizer (``training/flow_pretrain.py``) and the artifact store
(``utils/ckpt.py``), float32, on the same numpy-seeded inputs: the lookup's
values and level cotangents (points past the border clamped), every
submodule, RAFT at 64x64 b2 with 2 iterations and 2 levels from JAX's
weights (biases perturbed: every prediction and every gradient leaf, the
context net's to 2e-3: ``CNET_GTOL``; the feature net's normalised biases,
whose exact gradient is 0, to 1e-5 of the largest gradient), one
clipped AdamW step, and JAX's bundled ``raft-artificial`` artifact (orbax)
bridged into a port run: the same flow on one batch.  Values to 1e-5 of
the reference's largest value, gradients to 1e-4 of each leaf's largest
value.  JAX's filter representation (``radius=R``) fails at every R, and so
does the port's.  The kernel's own tests are in
``test_torch_port_corr_lookup.py`` (no JAX, so they run on the card).

Run as a script, ``python tests/test_torch_port_raft.py --bridge OUT_DIR``
writes JAX's bundled artifact as a port run (``OUT_DIR/checkpoints/<step>``),
which ``--flow-checkpoint OUT_DIR`` and ``flow_checkpoint`` read."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from opticalflowdiffusion_tpu.models import raft as jraft
from opticalflowdiffusion_tpu.ops import correlation as jcorr
from opticalflowdiffusion_tpu_torch.models import raft as praft
from opticalflowdiffusion_tpu_torch.ops import correlation as pcorr
from opticalflowdiffusion_tpu_torch.training import flow_pretrain as pfp
from opticalflowdiffusion_tpu_torch.utils import ckpt as pckpt
from opticalflowdiffusion_tpu_torch.utils.weights import raft_jax_layout, raft_rows, raft_state_dict

RTOL = 1e-5        # f32 values, of the reference's largest |value|
GTOL = 1e-4        # gradients, of each leaf's largest |value|
# the context net's gradients: it has no norm, and in this case one ReLU of
# its block 3 sees an input within float32 noise of zero, which the port's
# float32 and JAX's round to opposite signs; the leaves that feed it then
# differ by up to 1.2e-3 (the port in float64 equals JAX's float64 to 1.3e-7
# on every leaf)
CNET_GTOL = 2e-3
ROOT = Path(__file__).resolve().parents[1]
JAX_RAFT = ROOT / "parity" / "flow_pretrain" / "checkpoints"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jax_f32_products():
    """JAX's products in full float32, as the port's on the CPU."""
    with jax.default_matmul_precision("highest"):
        yield


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _close(got, want, tol=RTOL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (msg, np.abs(got - want).max(), scale)


# ------------------------------------------------------------ correlation
@pytest.mark.parametrize("shape", ((1, 8, 4, 6), (2, 16, 8, 12)))
def test_allpairs_correlation_matches_jax(shape):
    B, C, H, W = shape
    rng = np.random.default_rng(C)
    f1, f2 = (rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(2))
    want = jcorr.allpairs_correlation(jnp.asarray(f1), jnp.asarray(f2))
    got = pcorr.allpairs_correlation(_nchw(f1), _nchw(f2))
    assert got.dtype == torch.float32 and got.shape == (B, H, W, H, W)
    _close(got.numpy(), want)


def test_avg_pool2d_matches_jax_and_odd_sides_raise():
    x = np.random.default_rng(0).standard_normal((6, 8, 12)).astype(np.float32)
    _close(pcorr.avg_pool2d(torch.from_numpy(x)).numpy(), jcorr.avg_pool2d(jnp.asarray(x)))
    odd = np.zeros((2, 7, 4), np.float32)
    with pytest.raises(TypeError):                      # JAX's reshape
        jcorr.avg_pool2d(jnp.asarray(odd))
    with pytest.raises(ValueError, match="reshape"):
        pcorr.avg_pool2d(torch.from_numpy(odd))


def test_lookup_taps_are_jax_order():
    """Tap i * (2r + 1) + j is (dx, dy) = (j - r, i - r)."""
    r = 2
    taps = pcorr.lookup_taps(r).numpy()
    for k, (dx, dy) in enumerate(taps):
        i, j = divmod(k, 2 * r + 1)
        assert (dx, dy) == (j - r, i - r)


def _pyramid_case(seed, B=2, H=8, W=12, levels=3, spread=7.0):
    rng = np.random.default_rng(seed)
    f1, f2 = (rng.standard_normal((B, H, W, 16)).astype(np.float32) for _ in range(2))
    pyr = jraft.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), levels)
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1)
    coords = (grid[None] + rng.uniform(-spread, spread, (B, H, W, 2))).astype(np.float32)
    coords[0, :2] = np.round(coords[0, :2])               # integer points, and far outside
    coords[1, -1, :3] = (-40.0, 55.5)
    return pyr, coords


@pytest.mark.parametrize("radius", (1, 4))
def test_corr_lookup_and_level_cotangents_match_jax(radius):
    """The plain lookup against JAX's on a 3-level pyramid (points past
    every border), and the cotangent of each level (the coords carry
    none)."""
    pyr, coords = _pyramid_case(radius)
    want, vjp = jax.vjp(lambda p: jraft.corr_lookup(p, jnp.asarray(coords), radius), pyr)
    g = np.random.default_rng(7).standard_normal(want.shape).astype(np.float32)
    (want_grads,) = vjp(jnp.asarray(g))
    levels = [torch.from_numpy(np.array(p)[..., 0]).requires_grad_() for p in pyr]
    got = pcorr.corr_lookup(levels, torch.from_numpy(coords), radius)
    _close(got.detach().numpy(), want)
    got_grads = torch.autograd.grad(got, levels, torch.from_numpy(g))
    for lv, (gg, wg) in enumerate(zip(got_grads, want_grads)):
        _close(gg.numpy(), np.asarray(wg)[..., 0], msg=f"level {lv}")


def test_corr_pyramid_matches_jax_and_clamps_its_depth():
    rng = np.random.default_rng(3)
    f1, f2 = (rng.standard_normal((1, 4, 8, 16)).astype(np.float32) for _ in range(2))
    want = jraft.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 6)
    got = praft.corr_pyramid(_nchw(f1), _nchw(f2), 6)
    assert len(got) == len(want) == praft.max_levels(4, 8) == 3
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w)[..., 0])


# ----------------------------------------------------------------- RAFT
@pytest.fixture(scope="module")
def raft_case():
    """RAFT(iters=2, corr_levels=2) at 64x64 b2 from JAX's weights (biases
    perturbed) on the port and JAX: (params, frames, flow_gt, JAX's
    predictions, its loss and gradients)."""
    rng = np.random.default_rng(11)
    f1 = rng.random((2, 64, 64, 3)).astype(np.float32)
    f2 = np.roll(f1, (2, -3), axis=(1, 2))
    gt = rng.uniform(-2, 2, (2, 64, 64, 2)).astype(np.float32)
    jm = jraft.RAFT(iters=2, corr_levels=2)
    params = jm.init(jax.random.PRNGKey(1), f1, f2)["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.02 * jnp.asarray(rng.standard_normal(a.shape), jnp.float32)
        if a.ndim == 1 else a, params)

    def loss_fn(p):
        preds = jm.apply({"params": p}, f1, f2)
        n = len(preds)
        return sum((0.8 ** (n - i - 1)) * jnp.mean(jnp.abs(x - gt)) for i, x in enumerate(preds)), preds

    (loss, preds), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return dict(params=jax.device_get(params), f1=f1, f2=f2, gt=gt, preds=preds,
                loss=float(loss), grads=jax.device_get(grads))


def _port(params, **kw):
    net = praft.RAFT(**kw)
    net.load_state_dict(raft_state_dict(params))
    return net


def test_raft_predictions_and_gradients_match_jax(raft_case):
    c = raft_case
    net = _port(c["params"], iters=2, corr_levels=2)
    preds = net(_nchw(c["f1"]), _nchw(c["f2"]))
    assert len(preds) == 2
    for i, (g, w) in enumerate(zip(preds, c["preds"])):
        _close(_nhwc(g), w, msg=f"prediction {i}")
    loss = pfp.sequence_loss(preds, _nchw(c["gt"]))
    np.testing.assert_allclose(float(loss.detach()), c["loss"], rtol=RTOL)
    loss.backward()
    got = raft_jax_layout({k: p.grad for k, p in net.named_parameters()}, c["params"])
    top = max(np.abs(w).max() for w in jax.tree_util.tree_leaves(c["grads"]))
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(c["grads"])):
        name = jax.tree_util.keystr(path)
        if _normalised_bias(name):
            # the instance norm after the conv removes a per-channel constant:
            # the exact gradient is 0, both sides hold float noise
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * top, name
            continue
        _close(g, w, CNET_GTOL if name.startswith("['cnet']") else GTOL, msg=name)


def _normalised_bias(name: str) -> bool:
    """A bias of the feature net that an instance norm follows: the stem's
    and the residual blocks' (not the output conv's)."""
    return (name.startswith("['fnet']") and name.endswith("['bias']")
            and not name.startswith("['fnet']['Conv_1']"))


def test_flow_pretrain_starts_from_flax_defaults():
    """``flow_pretrain.setup``'s RAFT against JAX's ``init`` leaf by leaf:
    biases 0 as JAX's, every kernel within flax's truncated lecun_normal
    bound at its fan_in (2 / 0.8796 standard deviations), and on a leaf of
    200 entries or more its standard deviation times sqrt(fan_in) within
    0.25 of 1, as JAX's is."""
    bound = 2.0 / 0.87962566103423978
    x = np.zeros((1, 64, 64, 3), np.float32)
    params = jax.device_get(jraft.RAFT(iters=2, corr_levels=2).init(
        jax.random.PRNGKey(0), x, x)["params"])
    fan = raft_state_dict(jax.tree_util.tree_map_with_path(
        lambda path, a: np.full(a.shape, np.prod(a.shape[:-1]) if str(path[-1].key) == "kernel"
                                else 0, np.float32), params))
    want = raft_state_dict(params)
    net, _ = pfp.setup(iters=2, corr_levels=2, device="cpu")
    got = dict(net.named_parameters())
    assert set(got) == set(want)
    for key, p in got.items():
        p, w, f = p.detach(), want[key], float(fan[key].flatten()[0])
        if f == 0:
            assert torch.equal(p, w) and not w.any(), key
            continue
        scale = np.sqrt(f)
        assert float(p.abs().max()) * scale <= bound + 1e-5, key
        if p.numel() >= 200:
            assert abs(float(p.std()) * scale - 1.0) < 0.25, key
            assert abs(float(w.std()) * scale - 1.0) < 0.25, key


def test_raft_weight_table_both_ways(raft_case):
    params = raft_case["params"]
    sd = raft_state_dict(params)
    assert set(sd) == set(praft.RAFT(corr_levels=2).state_dict())
    assert len(raft_rows()) == len(jax.tree_util.tree_leaves(params)) == len(sd)
    back = raft_jax_layout(sd, params)
    for (path, leaf), (_, want) in zip(jax.tree_util.tree_leaves_with_path(back),
                                       jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(leaf, np.asarray(want), err_msg=str(path))


def _inputs(rng, shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


SUBMODULES = {
    # name: (JAX module, port module of the RAFT, its sub-tree, input shapes NHWC)
    "feature_encoder": (lambda: jraft.BasicEncoder(256, "instance"), lambda n: n.fnet,
                        ("fnet",), [(2, 64, 48, 3)]),
    "context_encoder": (lambda: jraft.BasicEncoder(256, "none"), lambda n: n.cnet,
                        ("cnet",), [(2, 64, 48, 3)]),
    "residual_block_stride2": (lambda: jraft.ResidualBlock(96, "instance", 2),
                               lambda n: n.fnet.blocks[2], ("fnet", "ResidualBlock_2"),
                               [(2, 15, 10, 64)]),
    "residual_block_none": (lambda: jraft.ResidualBlock(64, "none", 1),
                            lambda n: n.cnet.blocks[1], ("cnet", "ResidualBlock_1"),
                            [(2, 9, 12, 64)]),
    "motion_encoder": (lambda: jraft.BasicMotionEncoder(2, 4), lambda n: n.update_block.encoder,
                       ("update_block", "BasicMotionEncoder_0"), [(2, 8, 8, 2), (2, 8, 8, 162)]),
    "sep_conv_gru": (lambda: jraft.SepConvGRU(128), lambda n: n.update_block.gru,
                     ("update_block", "SepConvGRU_0"), [(2, 8, 8, 128), (2, 8, 8, 256)]),
    "flow_head": (lambda: jraft.FlowHead(2), lambda n: n.update_block.flow_head,
                  ("update_block", "FlowHead_0"), [(2, 8, 8, 128)]),
    "update_block": (lambda: jraft.BasicUpdateBlock(2, 4, 128), lambda n: n.update_block,
                     ("update_block",), [(2, 8, 8, 128), (2, 8, 8, 128), (2, 8, 8, 162),
                                         (2, 8, 8, 2)]),
}


@pytest.mark.parametrize("name", sorted(SUBMODULES))
def test_submodules_match_jax(raft_case, name):
    make_j, pick, path, shapes = SUBMODULES[name]
    sub = raft_case["params"]
    for k in path:
        sub = sub[k]
    xs = _inputs(np.random.default_rng(len(name)), shapes)
    want = make_j().apply({"params": sub}, *map(jnp.asarray, xs))
    with torch.no_grad():
        got = pick(_port(raft_case["params"], corr_levels=2))(*map(_nchw, xs))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(_nhwc(g), w, msg=f"output {i}")


def test_grid_and_upsamplers_match_jax():
    rng = np.random.default_rng(5)
    want = jraft.coords_grid(2, 3, 5)
    _close(_nhwc(praft.coords_grid(2, 3, 5)), want)
    flow = rng.standard_normal((2, 4, 6, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 4, 6, 576)).astype(np.float32)
    _close(_nhwc(praft.upflow8(_nchw(flow))), jraft.upflow8(jnp.asarray(flow)))
    _close(_nhwc(praft.convex_upsample(_nchw(flow), _nchw(mask))),
           jraft.convex_upsample(jnp.asarray(flow), jnp.asarray(mask)))


@pytest.mark.parametrize("radius", (3, 17))
def test_filter_mode_raises_as_jax(radius):
    """JAX's RAFT(radius=R) fails at ConvToFilter's reshape (289 channels
    read as 3 x 3 x 32); the port's raises, saying so."""
    x = np.zeros((1, 64, 64, 3), np.float32)
    with pytest.raises(TypeError, match="reshape"):
        jraft.RAFT(radius=radius, iters=1, corr_levels=2).init(jax.random.PRNGKey(0), x, x)
    with pytest.raises(ValueError, match="288"):
        praft.RAFT(radius=radius, iters=1, corr_levels=2)(_nchw(x), _nchw(x))


def test_shallow_grid_matches_jax():
    """C14: a 32x32 frame's 4 x 4 grid holds 3 levels; JAX's init sizes its
    motion encoder for them (3 x 81 channels), and the port's RAFT built for
    that image size gives JAX's flow through ``raft_rows``.  A RAFT whose
    encoder was built for 4 levels raises on that grid, naming
    ``image_size``."""
    rng = np.random.default_rng(3)
    f1 = rng.random((2, 32, 32, 3)).astype(np.float32)
    f2 = np.roll(f1, (1, -2), axis=(1, 2))
    jm = jraft.RAFT(iters=2, corr_levels=4)
    params = jax.device_get(jm.init(jax.random.PRNGKey(2), f1, f2)["params"])
    want = jax.jit(jm.apply)({"params": params}, f1, f2)
    sd = raft_state_dict(params)
    assert sd["update_block.encoder.convc1.weight"].shape[1] == 3 * 81
    assert praft.grid_levels(32) == praft.grid_levels((32, 40)) == 3
    net = praft.RAFT(iters=2, corr_levels=4, image_size=32)
    net.load_state_dict(sd)
    with torch.no_grad():
        got = net(_nchw(f1), _nchw(f2))
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        _close(_nhwc(g), w, msg=f"prediction {i}")
    assert float(np.abs(np.asarray(want[-1])).max()) > 1e-3
    x = torch.zeros(1, 3, 32, 32)
    with pytest.raises(ValueError, match="image_size"):
        praft.RAFT(iters=1, corr_levels=4)(x, x)


def test_adamw_step_matches_jax(raft_case):
    """One step of optax's clip_by_global_norm(1.0) -> adamw(2e-4) (decay
    1e-4 on every leaf) against the port's: the loss, and each update where
    the gradient is not near zero (Adam's first step is lr * sign there),
    outside the context net (whose gradients agree to ``CNET_GTOL`` only,
    which Adam's normalisation magnifies where a gradient is small) and the
    normalised biases (whose gradients are float noise)."""
    c = raft_case
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(2e-4))
    updates, _ = tx.update(c["grads"], tx.init(c["params"]), c["params"])
    net = _port(c["params"], iters=2, corr_levels=2)
    state, step = pfp.make_step(net, lr=2e-4)
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    loss, _ = step(state, _nchw(c["f1"]), _nchw(c["f2"]), _nchw(c["gt"]))
    np.testing.assert_allclose(float(loss), c["loss"], rtol=RTOL)
    got = raft_jax_layout({k: p.detach() - before[k] for k, p in net.named_parameters()},
                          c["params"])
    for (path, g), (_, w), (_, gr) in zip(jax.tree_util.tree_leaves_with_path(got),
                                          jax.tree_util.tree_leaves_with_path(updates),
                                          jax.tree_util.tree_leaves_with_path(c["grads"])):
        name = jax.tree_util.keystr(path)
        if name.startswith("['cnet']") or _normalised_bias(name):
            continue
        gr = np.abs(np.asarray(gr))
        sure = gr > 1e-3 * gr.max()
        np.testing.assert_allclose(np.asarray(g)[sure], np.asarray(w)[sure], rtol=1e-3,
                                   atol=1e-9, err_msg=name)


# ------------------------------------------------------ the bundled artifact
def jax_raft_artifact():
    """(JAX's bundled raft-artificial params, its step), restored with orbax."""
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(JAX_RAFT.absolute())
    try:
        step = mgr.latest_step()
        tree = mgr.restore(step, args=ocp.args.StandardRestore())
    finally:
        mgr.close()
    return tree["params"], step


def write_raft_run(run_dir) -> Path:
    """JAX's bundled raft-artificial artifact as a port run directory."""
    params, step = jax_raft_artifact()
    ck = Path(run_dir) / "checkpoints" / str(step)
    ck.mkdir(parents=True, exist_ok=True)
    torch.save({"step": int(step), "module": raft_state_dict(params)}, ck / "state.pt")
    return Path(run_dir)


def test_bundled_orbax_artifact_raises_naming_the_bridge(monkeypatch, tmp_path):
    monkeypatch.setenv("OFD_ARTIFACT_ROOT", str(tmp_path))
    with pytest.raises(ValueError, match="--bridge"):
        pckpt.resolve_artifact("raft-artificial")
    with pytest.raises(FileNotFoundError):
        pckpt.resolve_artifact("no-such-artifact")


def test_bridged_artifact_gives_jax_flow(tmp_path, monkeypatch):
    """JAX's trained RAFT (4 levels), bridged into a port run and published
    under another name, gives JAX's flow on a batch of its training data
    (2 iterations here: the weights do not depend on the count)."""
    from opticalflowdiffusion_tpu_torch.config import ArtificialDataConfig
    from opticalflowdiffusion_tpu_torch.data.artificial import ArtificialDataset

    run = write_raft_run(tmp_path / "run")
    monkeypatch.setenv("OFD_ARTIFACT_ROOT", str(tmp_path / "store"))
    pckpt.publish_artifact("raft-bridged", run / "checkpoints")
    ds = ArtificialDataset(ArtificialDataConfig(image_size=64, size=8, seed=0))
    f1, f2 = (np.stack([ds[i][k] for i in range(2)]) for k in (0, 1))
    params, _ = jax_raft_artifact()
    want = jraft.RAFT(iters=2, corr_levels=4).apply({"params": params}, f1, f2)[-1]
    net = praft.RAFT(iters=2, corr_levels=4)
    net.load_state_dict(pckpt.load_artifact("raft-bridged"))
    with torch.no_grad():
        got = net(_nchw(f1), _nchw(f2))[-1]
    _close(_nhwc(got), want)
    assert float(np.abs(np.asarray(want)).max()) > 0.1


if __name__ == "__main__":
    # python tests/test_torch_port_raft.py --bridge OUT_DIR
    if len(sys.argv) != 3 or sys.argv[1] != "--bridge":
        sys.exit(__doc__)
    print(write_raft_run(sys.argv[2]))
