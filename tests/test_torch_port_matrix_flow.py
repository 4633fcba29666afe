"""Port vs JAX for MatrixFlow (``algorithms/matrix_flow.py``) and the
backward warp (``ops/warp.py``'s ``bilinear_gather`` and
``warp_backward_flow``), at 16x16, b2, radius 5, float32, on the same
numpy-seeded inputs: the filter application in every mode and colour
variant (the NaN holes of ``weighted_sum`` filled from the blurred frame,
the ties of ``mode``), the flow warps, the filter inversion, the
filter-flow conversions (rounding ties, ties of the argmax), each loss
term, and for the three goals ``loss_fn`` with its gradients and
``val_step``'s metrics on a narrow UNet (``Unet(16, dim_mults=(1, 2))``,
set on both sides) with JAX's weights carried over; and the family
stage's training over six Adam steps on the same weights and batches (each
loss to 1e-4 relative, the weights after them to 1e-4 of each leaf's
largest value).  Values to 1e-5 relative, gradients to 1e-4 of each leaf's
largest value.  With a colour
weight (``cols``) JAX's ``val_step`` raises (its optimal filter has no
colour-weight channel, which the split expects); so does the port's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowdiffusion_tpu.algorithms.matrix_flow import MatrixFlow as JMatrixFlow
from opticalflowdiffusion_tpu.config import compose
from opticalflowdiffusion_tpu.models.unet import Unet as JUnet
from opticalflowdiffusion_tpu.ops import warp as jwarp
from opticalflowdiffusion_tpu_torch.algorithms.base import to_batch
from opticalflowdiffusion_tpu_torch.algorithms.matrix_flow import MatrixFlow
from opticalflowdiffusion_tpu_torch.config import FLAGSHIP_DATA, MATRIX_FLOW_ALGO
from opticalflowdiffusion_tpu_torch.data.artificial import ArtificialDataset
from opticalflowdiffusion_tpu_torch.models.unet import Unet
from opticalflowdiffusion_tpu_torch.ops import warp as pwarp
from opticalflowdiffusion_tpu.parallel.train import TrainState
from opticalflowdiffusion_tpu_torch.parallel.train import TrainState as PTrainState
from opticalflowdiffusion_tpu_torch.parallel.train import make_optimizer, make_train_step
from opticalflowdiffusion_tpu_torch.utils.weights import jax_layout, params_from_jax

S, B, R = 16, 2, 5
R2 = R * R
COLS = (None, "ones", "any")
# the filter_pred case weighs every regulariser so that each term's
# gradient is held
REG = dict(smoothness_weight=0.1, copout_weight=0.1, identity_weight=0.01,
           divergence_weight=0.1, inversion_weight=0.1)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jax_f32_products():
    """JAX's products in full float32, as the port's on the CPU: XLA's
    default precision may take a float32 dot in fewer bits on this host's
    CPU (a 3e-5 relative difference in some runs)."""
    with jax.default_matmul_precision("highest"):
        yield


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _pair(cols=None, goal="gt_flow_pred", **fields):
    """(JAX MatrixFlow, port MatrixFlow) of one configuration, f32."""
    over = [f"algorithm.image_size={S},{S}", f"algorithm.radius={R}", f"algorithm.goal={goal}"]
    over += [f"algorithm.{k}={v}" for k, v in fields.items()]
    if cols is not None:
        over.append(f"+algorithm.cols={cols}")
    cfg = compose(["experiment=matrix_flow", "algorithm=matrix_flow", "dataset=artificial",
                   *over]).algorithm
    port = dataclasses.replace(MATRIX_FLOW_ALGO, image_size=f"{S},{S}", radius=R, goal=goal,
                               cols=cols, precision="float32", **fields)
    return JMatrixFlow(cfg), MatrixFlow(port, device="cpu",
                                        generator=torch.Generator().manual_seed(0))


def _items(seed=3):
    data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=S, seed=seed, size=8))
    return [data[i] for i in range(B)]


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    got = np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=msg)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol, err_msg=msg)


def test_bilinear_gather_and_backward_warp_match_jax():
    """Flows up to 6 px at 16x16: samples outside the frame (clamped taps,
    masked by warp_backward_flow) and inside, integer and fractional."""
    rng = np.random.default_rng(0)
    img = rng.random((B, S, S, 3)).astype(np.float32)
    flow = rng.uniform(-6, 6, (B, S, S, 2)).astype(np.float32)
    flow[0, :4] = np.round(flow[0, :4])
    cx = np.arange(S, dtype=np.float32)[None, None] + flow[..., 0]
    cy = np.arange(S, dtype=np.float32)[None, :, None] + flow[..., 1]
    want = jwarp.bilinear_gather(jnp.asarray(img), jnp.asarray(cx), jnp.asarray(cy))
    got = pwarp.bilinear_gather(_nchw(img), torch.from_numpy(cx), torch.from_numpy(cy))
    _close(_nhwc(got), want)
    want_w, want_m = jwarp.warp_backward_flow(jnp.asarray(img), jnp.asarray(flow))
    got_w, got_m = pwarp.warp_backward_flow(_nchw(img), _nchw(flow))
    _close(_nhwc(got_w), want_w)
    np.testing.assert_array_equal(_nhwc(got_m), np.asarray(want_m))
    assert 0 < float(np.asarray(want_m).mean()) < 1


def _filter(cols, mode, seed=1):
    """Raw filter channels (B, H, W, K) for ``mode``: logits for softmax,
    logits on a grid of 0.5 for mode (ties), non-negative weights with
    pixels of all-zero taps for weighted_sum (NaN holes)."""
    K = R2 + (cols is not None) + 3 * (cols == "any")
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(B, S, S, K)).astype(np.float32)
    if mode == "mode":
        f = np.round(f * 2) / 2
    if mode in ("weighted_sum", "none"):
        f = np.maximum(f, 0)
        f[:, 3:5, 2:9, :R2] = 0
    return f


@pytest.mark.parametrize("cols", COLS, ids=lambda c: f"cols_{c}")
@pytest.mark.parametrize("mode", ("softmax", "mode", "weighted_sum", "none"))
def test_apply_filter_matches_jax(mode, cols):
    jalgo, algo = _pair(cols)
    img = np.random.default_rng(2).random((B, S, S, 3)).astype(np.float32)
    fil = _filter(cols, mode)
    want, want_f = jalgo.apply_filter(jnp.asarray(fil), jnp.asarray(img), mode=mode)
    got, got_f = algo.apply_filter(_nchw(fil), _nchw(img), mode=mode)
    _close(_nhwc(got), want, msg="applied")
    _close(_nhwc(got_f), want_f, msg="filter")
    if mode == "weighted_sum":
        # the holes filled from the blur, but for the colour term (its
        # weight is a NaN there too)
        assert np.isnan(np.asarray(want_f)).any()
        assert np.isfinite(np.asarray(want)).all() == (cols != "any")
    if mode == "mode":
        assert (np.asarray(want_f)[..., :R2] == 0.5).any()      # a tie spread


@pytest.mark.parametrize("flow_in", ("second", "first"))
def test_apply_flow_matches_jax(flow_in):
    """A flow: the backward warp with the red fill, or the forward splat
    (``linear`` mode) with red in the holes."""
    jalgo, algo = _pair()
    rng = np.random.default_rng(4)
    img = rng.random((B, S, S, 3)).astype(np.float32)
    flow = rng.uniform(-3, 3, (B, S, S, 2)).astype(np.float32)
    want, _ = jalgo.apply_filter(jnp.asarray(flow), jnp.asarray(img), flow_in=flow_in)
    got, got_f = algo.apply_filter(_nchw(flow), _nchw(img), flow_in=flow_in)
    _close(_nhwc(got), want, rtol=1e-5, atol=1e-5)
    red = (np.asarray(want) == np.array([1, 0, 0], np.float32)).all(-1)
    assert red.any() and torch.equal(got_f, _nchw(flow))


@pytest.mark.parametrize("cols", COLS, ids=lambda c: f"cols_{c}")
def test_invert_and_vector_from_filter_match_jax(cols):
    jalgo, algo = _pair(cols)
    fil = _filter(cols, "softmax", seed=5)
    inv = jalgo.invert_filter(jnp.asarray(fil))
    got = algo.invert_filter(_nchw(fil))
    _close(_nhwc(got), inv, rtol=0, atol=0)
    _close(_nhwc(algo.vector_from_filter(_nchw(fil))), jalgo.vector_from_filter(jnp.asarray(fil)))


def test_filter_from_vector_and_mode_to_flow_match_jax():
    """Flows on half-integers (rounding ties to even) and beyond the
    radius (clipped); the argmax of filters with tied taps (the first)."""
    jalgo, algo = _pair()
    rng = np.random.default_rng(6)
    flow = (np.round(rng.uniform(-5, 5, (B, S, S, 2)) * 2) / 2).astype(np.float32)
    want = jalgo.filter_from_vector(jnp.asarray(flow))
    got = algo.filter_from_vector(_nchw(flow))
    _close(_nhwc(got), want, rtol=0, atol=0)
    fil = (np.round(rng.normal(size=(B, S, S, R2)) * 1.5) / 1.5).astype(np.float32)
    assert (np.sum(fil == fil.max(-1, keepdims=True), axis=-1) > 1).any()
    np.testing.assert_array_equal(_nhwc(algo.mode_to_flow(_nchw(fil))),
                                  np.asarray(jalgo.mode_to_flow(jnp.asarray(fil))))


TERMS = ("smoothness", "copout", "corrective", "identity", "divergence", "inversion")


@pytest.mark.parametrize("term", TERMS)
def test_loss_terms_match_jax(term):
    """Each loss term on a softmax filter with colours, frames of the
    artificial dataset (a white frame among them for the corrective
    term)."""
    jalgo, algo = _pair("any", goal="filter_pred")
    items = _items()
    img, tgt = (np.stack(f) for f in list(zip(*items))[:2])
    img[1] = 1.0
    raw = _filter("any", "softmax", seed=7)
    _, jfil = jalgo.apply_filter(jnp.asarray(raw), jnp.asarray(img))
    _, fil = algo.apply_filter(_nchw(raw), _nchw(img))
    ji, jt = jnp.asarray(img), jnp.asarray(tgt)
    pi, pt = _nchw(img), _nchw(tgt)
    args = {"smoothness": ((jfil, jt), (fil, pt)), "copout": ((jfil,), (fil,)),
            "corrective": ((ji, jt), (pi, pt)), "identity": ((jfil,), (fil,)),
            "divergence": ((jfil,), (fil,)), "inversion": ((jfil, ji, jt), (fil, pi, pt))}[term]
    want = float(getattr(jalgo, f"{term}_loss")(*args[0]))
    got = float(getattr(algo, f"{term}_loss")(*args[1]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert want != 0.0


def _random_params(jalgo, cond, seed=1):
    """JAX's parameter tree of the narrow UNet filled from numpy (kernels
    N(0, 1/fan_in), biases N(0, 0.02^2), gains 1 + N(0, 0.02^2))."""
    shapes = jax.eval_shape(lambda r, x: jalgo.module.init(r, x, None, None),
                            jax.random.PRNGKey(0), cond)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        if name.endswith("kernel"):
            v = rng.standard_normal(leaf.shape) / np.sqrt(int(np.prod(leaf.shape[:-1])))
        elif name.endswith("bias"):
            v = rng.standard_normal(leaf.shape) * 0.02
        else:
            v = 1.0 + rng.standard_normal(leaf.shape) * 0.02
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


GOAL_CASES = {"gt_flow_pred": (None, {}), "filter_pred": ("any", REG),
              "gt_filter_pred": (None, {})}


class _Raised:
    """The exception type a val_step raised (JAX's, with a colour weight)."""

    def __init__(self, exc):
        self.type = type(exc)


@pytest.fixture(scope="module", params=tuple(GOAL_CASES))
def goal_case(request):
    """JAX's loss, gradients and val_step metrics for one goal on the
    narrow UNet (one jitted compile each), and the port on its weights."""
    goal = request.param
    cols, fields = GOAL_CASES[goal]
    jalgo, algo = _pair(cols, goal=goal, **fields)
    out_dim = algo.module.final_conv.weight.shape[0]
    jalgo.module = JUnet(16, dim_mults=(1, 2), channels=6, out_dim=out_dim, time_in=False)
    algo.module = Unet(16, dim_mults=(1, 2), channels=6, out_dim=out_dim, time_in=False)
    items = _items()
    jbatch = tuple(jnp.asarray(np.stack(f)) for f in zip(*items))
    cond = jnp.concatenate([2.0 * jbatch[0] - 1.0, 2.0 * jbatch[1] - 1.0], axis=-1)
    params = _random_params(jalgo, cond)
    rng = jax.random.PRNGKey(2)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jalgo.loss_fn(p, jbatch, rng), has_aux=True))(params)
    try:
        vmetrics, arts = jax.jit(jalgo.val_step)(params, jbatch, rng)
        vmetrics = {k: float(v) for k, v in vmetrics.items()}
        arts = {k: np.asarray(v) for k, v in arts.items()}
    except TypeError as e:                          # the colour weight's quirk
        vmetrics, arts = _Raised(e), None
    algo.module.load_state_dict(params_from_jax(params))
    return dict(goal=goal, items=items, params=params, loss=float(loss), grads=grads,
                metrics={k: float(v) for k, v in metrics.items()}, vmetrics=vmetrics,
                arts=arts, algo=algo)


def test_loss_fn_and_gradients_match_jax(goal_case):
    algo = goal_case["algo"]
    algo.module.zero_grad(set_to_none=True)
    loss, metrics = algo.loss_fn(to_batch(goal_case["items"], "cpu"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), goal_case["loss"], rtol=1e-5)
    for k, want in goal_case["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=1e-5, atol=1e-7, err_msg=k)
    grads = {k: p.grad for k, p in algo.module.named_parameters()}
    got = dict(_leaves(jax_layout(grads, goal_case["params"], prefix="")))
    want = dict(_leaves(goal_case["grads"]))
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    assert top > 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-8 * top, err_msg=name)
    algo.module.zero_grad(set_to_none=True)


def test_val_step_matches_jax(goal_case):
    """Every metric of JAX's val_step (the mode filter's and the optimal
    filter's for the filter goals) and the applied frames; with a colour
    weight both raise."""
    if isinstance(goal_case["vmetrics"], _Raised):
        assert GOAL_CASES[goal_case["goal"]][0] is not None
        with pytest.raises(RuntimeError, match="shape"):
            goal_case["algo"].val_step(to_batch(goal_case["items"], "cpu"))
        return
    metrics, arts = goal_case["algo"].val_step(to_batch(goal_case["items"], "cpu"))
    assert metrics.keys() == goal_case["vmetrics"].keys()
    for k, want in goal_case["vmetrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=1e-5, atol=1e-7, err_msg=k)
    for k, want in goal_case["arts"].items():
        _close(_nhwc(arts[k]), want, rtol=1e-5, atol=1e-5, msg=k)


def test_weights_round_trip(goal_case):
    back = dict(_leaves(jax_layout(params_from_jax(goal_case["params"]), goal_case["params"],
                                   prefix="")))
    for name, w in _leaves(goal_case["params"]):
        np.testing.assert_array_equal(back[name], w, err_msg=name)


def test_raft_architecture_raises():
    """JAX's ``architecture: raft`` branch cannot run: its init calls RAFT
    with one 6-channel tensor and None for the second frame.  The port
    raises at construction, saying so."""
    jalgo = JMatrixFlow(compose([
        "experiment=matrix_flow", "algorithm=matrix_flow", "dataset=artificial",
        f"algorithm.image_size={S},{S}", f"algorithm.radius={R}", "algorithm.goal=filter_pred",
        "algorithm.architecture=raft"]).algorithm)
    batch = tuple(jnp.asarray(np.stack(f)) for f in zip(*_items()))
    with pytest.raises(AttributeError, match="ndim"):
        jalgo.init(jax.random.PRNGKey(0), batch)
    with pytest.raises(NotImplementedError, match="None for the second frame"):
        MatrixFlow(dataclasses.replace(MATRIX_FLOW_ALGO, architecture="raft"), device="cpu")


ADAM_STEPS = 6


def test_filter_pred_losses_follow_jax_over_adam_steps():
    """The family stage's training (goal filter_pred, lr 2e-4, radius 5,
    clip 100, Adam with L2 decay 1e-6) on the narrow UNet at 16x16 b2: from
    the same weights, over the same batches, each step's loss within 1e-4
    relative of JAX's and the weights after the last step within 1e-4 of
    each leaf's largest value (Adam's first steps move every weight by
    about lr, so a wrong update shows at once)."""
    jalgo, algo = _pair(goal="filter_pred", lr=2e-4)
    out_dim = algo.module.final_conv.weight.shape[0]
    jalgo.module = JUnet(16, dim_mults=(1, 2), channels=6, out_dim=out_dim, time_in=False)
    algo.module = Unet(16, dim_mults=(1, 2), channels=6, out_dim=out_dim, time_in=False)
    data = ArtificialDataset(dataclasses.replace(FLAGSHIP_DATA, image_size=S, seed=7, size=64))
    batches = [[data[2 * i + j] for j in range(B)] for i in range(ADAM_STEPS)]
    jb = [tuple(jnp.asarray(np.stack(f)) for f in zip(*items)) for items in batches]
    cond = jnp.concatenate([2.0 * jb[0][0] - 1.0, 2.0 * jb[0][1] - 1.0], axis=-1)
    params = _random_params(jalgo, cond, seed=4)
    jstate = TrainState.create(params, jalgo.make_optimizer(100.0))
    key = jax.random.PRNGKey(1)

    @jax.jit
    def jstep(st, b):
        loss, g = jax.value_and_grad(lambda p: jalgo.loss_fn(p, b, key)[0])(st.params)
        return st.apply_gradients(g), loss

    algo.module.load_state_dict(params_from_jax(params))
    state = PTrainState(algo.module, make_optimizer(algo.module.parameters(), 2e-4, 1e-6, 100.0))
    step = make_train_step(algo.loss_fn)
    for i, (items, b) in enumerate(zip(batches, jb)):
        jstate, jloss = jstep(jstate, b)
        loss = float(step(state, to_batch(items, "cpu"), None)["train/loss"])
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-4, err_msg=f"step {i + 1}")
    got = dict(_leaves(jax_layout({k: v.detach() for k, v in algo.module.state_dict().items()},
                                  params, prefix="")))
    for name, w in _leaves(jax.device_get(jstate.params)):
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def _stage_jax():
    """JAX's MatrixFlow of the matrix parity stage."""
    return JMatrixFlow(compose([
        "experiment=matrix_flow", "dataset=artificial", "dataset.image_size=32",
        "dataset.size=4096", "+dataset.seed=7", "algorithm=matrix_flow",
        "algorithm.image_size=32,32", "algorithm.goal=filter_pred", "algorithm.radius=3",
        "algorithm.lr=2e-4"]).algorithm)


def _stage_init(algo, jalgo, batch, kind, seed):
    """JAX's initial parameters of the stage: its own draw from
    PRNGKey(seed) (``kind`` jax) or the port's ``init_weights`` draw from
    ``seed`` (``kind`` port), loaded into the port's module too."""
    from opticalflowdiffusion_tpu_torch.models.unet import init_weights

    params = jax.device_get(jalgo.init(jax.random.PRNGKey(seed), tuple(map(jnp.asarray, batch)),
                                       clip=100).params)
    if kind == "port":
        init_weights(algo.module, torch.Generator().manual_seed(seed))
        return jax_layout({k: v.detach() for k, v in algo.module.state_dict().items()}, params,
                          prefix="")
    algo.module.load_state_dict(params_from_jax(params))
    return params


if __name__ == "__main__":
    # The matrix parity stage (C11) on the CPU, at its settings and batches:
    #   python tests/test_torch_port_matrix_flow.py STEPS [jax|port SEED]
    #     JAX and the port in lockstep from the same initial weights (JAX's
    #     PRNGKey(SEED) draw, default 0, or the port's draw from SEED), the
    #     two losses every 5 steps (one epoch at most: 256 steps);
    #   python tests/test_torch_port_matrix_flow.py --escape jax|port SEEDS STEPS
    #     the port alone from each initial draw (SEEDS comma-separated), the
    #     mean loss over each 50 steps' last 10, and whether it left the
    #     identity filter (the last 10 under 0.01);
    #   python tests/test_torch_port_matrix_flow.py --jax-init OUT.pt [SEED]
    #     JAX's initial weights as the port's float32 state_dict, for
    #     ``parity_families.py --init-weights``.
    import sys

    from opticalflowdiffusion_tpu_torch.experiments.base import to_device
    from opticalflowdiffusion_tpu_torch.parallel.train import TrainState as PState
    from opticalflowdiffusion_tpu_torch.training import parity_families as pf

    torch.set_num_threads(2)
    args = sys.argv[1:]
    jalgo = _stage_jax()
    if args[0] == "--jax-init":
        algo, loader, _ = pf.stage_setup("matrix", "cpu")
        _stage_init(algo, jalgo, next(iter(loader)), "jax", int(args[2]) if len(args) > 2 else 0)
        torch.save(algo.module.state_dict(), args[1])
    elif args[0] == "--escape":
        for seed in (int(v) for v in args[2].split(",")):
            algo, loader, _ = pf.stage_setup("matrix", "cpu")
            _stage_init(algo, jalgo, next(iter(pf.stage_setup("matrix", "cpu")[1])), args[1],
                        seed)
            state = PState(algo.module, make_optimizer(algo.module.parameters(), 2e-4, 1e-6,
                                                       100.0))
            step = make_train_step(algo.loss_fn)
            algo.module.train()
            losses = [float(step(state, to_device(b, "cpu"), None)["train/loss"])
                      for _, b in zip(range(int(args[3])), loader)]
            curve = " ".join(f"{j}:{np.mean(losses[j - 10:j]):.5f}"
                             for j in range(50, len(losses) + 1, 50))
            print(args[1], seed, curve, "escaped" if np.mean(losses[-10:]) < 0.01 else "STUCK",
                  flush=True)
    else:
        steps = int(args[0])
        kind, seed = (args[1], int(args[2])) if len(args) > 2 else ("jax", 0)
        algo, train_loader, _ = pf.stage_setup("matrix", "cpu")
        batches = [b for _, b in zip(range(steps), train_loader)]
        params = _stage_init(algo, jalgo, batches[0], kind, seed)
        jstate = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                   jalgo.make_optimizer(100))
        key = jax.random.PRNGKey(1)

        @jax.jit
        def jstep(st, b):
            loss, g = jax.value_and_grad(lambda p: jalgo.loss_fn(p, b, key)[0])(st.params)
            return st.apply_gradients(g), loss

        state = PState(algo.module, make_optimizer(algo.module.parameters(), 2e-4, 1e-6, 100.0))
        step = make_train_step(algo.loss_fn)
        algo.module.train()
        for i, b in enumerate(batches):
            jstate, jloss = jstep(jstate, tuple(map(jnp.asarray, b)))
            loss = float(step(state, to_device(b, "cpu"), None)["train/loss"])
            if (i + 1) % 5 == 0 or i < 3:
                print(i + 1, float(jloss), loss, flush=True)
