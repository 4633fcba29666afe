"""Weight bridge between a flax UNet parameter tree (as numpy) and a torch
state_dict, both ways.

The state_dict uses the reference PyTorch UNet's keys, which are also the
keys of ``models/unet.py`` here, so the JAX->port direction is the inverse
of the per-block tables of the JAX package's ``utils/import_torch_ckpt.py``.
Conv kernels go from HWIO to OIHW, dense kernels are transposed, and the
Downsample 1x1 conv's input channels go from the JAX order (dy, dx, c) back
to the pixel-unshuffle order (c, dy, dx).  Every leaf maps to one key by a
pure re-layout, so the same table maps gradients, and :func:`jax_layout`
takes a port state_dict (or its gradients) back to the JAX tree, leaf by
leaf.  The same holds for the unfused ``LinearAttention`` and
``PreNormResidual(LinearAttention)`` on their own
(:func:`linear_attention_rows`, :func:`from_jax`, :func:`to_jax`), and for
FlowLearner's FlowUnet and FilterUnet with the filter codecs
(:func:`flow_learner_state_dict`, :func:`flow_learner_jax_layout`,
:func:`filter_codec_rows`; a flax ``ConvTranspose`` kernel is flipped
spatially for ``ConvTranspose2d``).  MatrixFlow's and FrameGenerator's
modules are plain UNets (:func:`params_from_jax`, :func:`jax_layout` with
no prefix); FlowCompleter's tree ``{"net": {"Unet_0": ...},
"null_embedding"}`` has :func:`flow_completer_state_dict` and
:func:`flow_completer_jax_layout`; PWCNet's tree :func:`pwc_state_dict` and
:func:`pwc_jax_layout` (:func:`pwc_rows`); RAFT's tree (flow mode)
:func:`raft_state_dict` and :func:`raft_jax_layout` (:func:`raft_rows`).
The classifiers' trees are the JAX ``Classifier``'s params, ``{"net":
<flax params>, "batch_stats": <flax batch_stats>}``: BatchNorm's ``scale``
and ``bias`` map to ``weight`` and ``bias``, its ``mean`` and ``var`` to the
``running_mean`` and ``running_var`` buffers (:func:`resnet_rows`,
:func:`mobilenet_rows`, with ``*_state_dict`` and ``*_jax_layout``; a
template without ``batch_stats`` maps the parameters alone, as gradients
have).  ``models/common.py``'s modules have :func:`common_rows`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Tree = Mapping[str, object]
Row = Tuple[Tuple[str, ...], str, str]  # (path in the flax tree, state_dict key, kind)


def _down_perm(four_c: int) -> np.ndarray:
    """Port input channel (c, dy, dx) of each JAX input channel (dy, dx, c)."""
    C = four_c // 4
    idx = np.arange(four_c)
    p1, p2, c = idx // (2 * C), (idx // C) % 2, idx % C
    return c * 4 + p1 * 2 + p2


def _to_port(kind: str, a: np.ndarray) -> np.ndarray:
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    if kind == "dense":
        return a.T
    if kind == "convT":                                 # (k, k, I, O) -> (I, O, k, k), flipped
        return a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if kind == "gain":
        return a.reshape(1, -1, 1, 1)
    if kind == "kernel1x1":
        return a.T[:, :, None, None]
    if kind == "down":
        w = a[0, 0].T                                   # (O, 4C), JAX order
        out = np.empty_like(w)
        out[:, _down_perm(w.shape[1])] = w
        return out[:, :, None, None]
    return a


def _to_jax(kind: str, a: np.ndarray, shape) -> np.ndarray:
    if kind == "conv":
        a = a.transpose(2, 3, 1, 0)
    elif kind == "convT":
        a = a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    elif kind == "dense":
        a = a.T
    elif kind == "kernel1x1":
        a = a[:, :, 0, 0].T
    elif kind == "down":
        w = a[:, :, 0, 0]
        a = w[:, _down_perm(w.shape[1])].T[None, None]
    return a.reshape(shape)


def _levels(params: Tree) -> int:
    """The UNet's number of levels (``len(dim_mults)``): its
    LinearAttentionBlocks are two a level."""
    return sum(k.startswith("LinearAttentionBlock_") for k in params) // 2


def _table(params: Tree, dim_mults: Optional[Sequence[int]] = None) -> List[Row]:
    """Rows of a JAX ``Unet`` tree.  The tree says which options it has:
    the time MLP (``time_in``), the Fourier embedding's weights and the
    levels (``dim_mults`` only checks their count)."""
    rows: List[Row] = []

    def conv(path, key):
        rows.append((path + ("kernel",), key + ".weight", "conv"))
        if "bias" in _get(params, path):
            rows.append((path + ("bias",), key + ".bias", "vec"))

    def dense(path, key):
        rows.append((path + ("kernel",), key + ".weight", "dense"))
        rows.append((path + ("bias",), key + ".bias", "vec"))

    def resnet_block(name, key):
        p = params[name]
        for flax_name, sub in (("Block_0", "block1"), ("Block_1", "block2")):
            conv((name, flax_name, "WSConv_0"), f"{key}.{sub}.proj")
            rows.append(((name, flax_name, "GroupNorm_0", "scale"), f"{key}.{sub}.norm.weight",
                         "vec"))
            rows.append(((name, flax_name, "GroupNorm_0", "bias"), f"{key}.{sub}.norm.bias",
                         "vec"))
        if "Dense_0" in p:
            dense((name, "Dense_0"), key + ".mlp.1")
        if "Conv_0" in p:
            conv((name, "Conv_0"), key + ".res_conv")

    def linear_attention_block(name, key):
        rows.extend([
            ((name, "prenorm_g"), key + ".fn.norm.g", "gain"),
            ((name, "qkv_kernel"), key + ".fn.fn.to_qkv.weight", "kernel1x1"),
            ((name, "out_kernel"), key + ".fn.fn.to_out.0.weight", "kernel1x1"),
            ((name, "out_bias"), key + ".fn.fn.to_out.0.bias", "vec"),
            ((name, "postnorm_g"), key + ".fn.fn.to_out.1.g", "gain"),
        ])

    R = _levels(params)
    if dim_mults is not None and len(dim_mults) != R:
        raise ValueError(f"the tree has {R} levels, dim_mults {tuple(dim_mults)}")
    conv(("Conv_0",), "init_conv")
    if "RandomOrLearnedSinusoidalPosEmb_0" in params:
        rows.append((("RandomOrLearnedSinusoidalPosEmb_0", "weights"), "time_mlp.0.weights",
                     "vec"))
    if "Dense_0" in params:                  # time_in
        dense(("Dense_0",), "time_mlp.1")
        dense(("Dense_1",), "time_mlp.3")
    rb, lab, cv = 0, 0, 1
    for i in range(R):
        for j in range(2):
            resnet_block(f"ResnetBlock_{rb}", f"downs.{i}.{j}")
            rb += 1
        linear_attention_block(f"LinearAttentionBlock_{lab}", f"downs.{i}.2")
        lab += 1
        if i < R - 1:
            rows.append(((f"Downsample_{i}", "Conv_0", "kernel"), f"downs.{i}.3.1.weight", "down"))
            rows.append(((f"Downsample_{i}", "Conv_0", "bias"), f"downs.{i}.3.1.bias", "vec"))
        else:
            conv((f"Conv_{cv}",), f"downs.{i}.3")
            cv += 1
    resnet_block(f"ResnetBlock_{rb}", "mid_block1")
    rb += 1
    rows.append((("PreNormResidual_0", "ChanLayerNorm_0", "g"), "mid_attn.fn.norm.g", "gain"))
    conv(("Attention_0", "Conv_0"), "mid_attn.fn.fn.to_qkv")
    conv(("Attention_0", "Conv_1"), "mid_attn.fn.fn.to_out")
    resnet_block(f"ResnetBlock_{rb}", "mid_block2")
    rb += 1
    for j in range(R):
        for k in range(2):
            resnet_block(f"ResnetBlock_{rb}", f"ups.{j}.{k}")
            rb += 1
        linear_attention_block(f"LinearAttentionBlock_{lab}", f"ups.{j}.2")
        lab += 1
        if j < R - 1:
            conv((f"Upsample_{j}", "Conv_0"), f"ups.{j}.3.1")
        else:
            conv((f"Conv_{cv}",), f"ups.{j}.3")
            cv += 1
    resnet_block(f"ResnetBlock_{rb}", "final_res_block")
    conv((f"Conv_{cv}",), "final_conv")
    return rows


def linear_attention_rows(prenorm: bool = False) -> List[Row]:
    """Rows of the JAX ``LinearAttention`` (``Conv_0`` the qkv 1x1 without
    bias, ``Conv_1`` the out 1x1, ``ChanLayerNorm_0``) against the port's
    ``to_qkv``, ``to_out.0``, ``to_out.1``; with ``prenorm`` those of
    ``PreNormResidual(LinearAttention)``: the inner module's under ``inner``
    and ``fn.fn.``, the pre-norm gain ``ChanLayerNorm_0.g`` as ``fn.norm.g``."""
    path, key = (("inner",), "fn.fn.") if prenorm else ((), "")
    rows = [
        (path + ("Conv_0", "kernel"), key + "to_qkv.weight", "conv"),
        (path + ("Conv_1", "kernel"), key + "to_out.0.weight", "conv"),
        (path + ("Conv_1", "bias"), key + "to_out.0.bias", "vec"),
        (path + ("ChanLayerNorm_0", "g"), key + "to_out.1.g", "gain"),
    ]
    if prenorm:
        rows.append((("ChanLayerNorm_0", "g"), "fn.norm.g", "gain"))
    return rows


def filter_codec_rows(c2f: bool = True, filter_to_conv: bool = False) -> List[Row]:
    """Rows of JAX's ``ConvToFilter`` (three ``ConvTranspose``, a ``Dense``)
    against ``models/filter_codec.py::ConvToFilter`` (``up.0-2``,
    ``dense``), or with ``filter_to_conv`` of the enabled ``FilterToConv``
    (three ``Conv``) against its ``convs.0-2``."""
    if filter_to_conv:
        return [r for i in range(3) for r in (
            ((f"Conv_{i}", "kernel"), f"convs.{i}.weight", "conv"),
            ((f"Conv_{i}", "bias"), f"convs.{i}.bias", "vec"))]
    rows = [r for i in range(3) for r in (
        ((f"ConvTranspose_{i}", "kernel"), f"up.{i}.weight", "convT"),
        ((f"ConvTranspose_{i}", "bias"), f"up.{i}.bias", "vec"))]
    return rows + [(("Dense_0", "kernel"), "dense.weight", "dense"),
                   (("Dense_0", "bias"), "dense.bias", "vec")]


def _learner_rows(params: Tree) -> List[Row]:
    """Rows of a JAX FlowUnet or FilterUnet tree (``Unet_0`` [and
    ``ConvToFilter_0``]) against FlowLearner's module (``model.``,
    ``codec.``)."""
    rows = [(("Unet_0",) + path, "model." + key, kind) for path, key, kind in
            _table(params["Unet_0"])]
    if "ConvToFilter_0" in params:
        rows += [(("ConvToFilter_0",) + path, "codec." + key, kind)
                 for path, key, kind in filter_codec_rows()]
    return rows


def flow_learner_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """State_dict of FlowLearner's module (FlowUnet, or FilterUnet with its
    codec) from the JAX params."""
    return from_jax(params, _learner_rows(params))


def flow_learner_jax_layout(sd: Mapping[str, torch.Tensor], template: Tree) -> Dict:
    """The JAX FlowUnet/FilterUnet tree of ``template`` from the port
    state_dict ``sd`` (parameters or their gradients)."""
    return to_jax(sd, template, _learner_rows(template))


def pwc_rows() -> List[Row]:
    """Rows of a JAX ``PWCNet`` tree against ``models/pwc_net.py::PWCNet``:
    the three pyramids' ``ConvFeatBlock_k/Conv_{0,1}`` and the decoders'
    ``dec_{fwd,bwd,occ}_k/Conv_{0..5}``."""
    rows: List[Row] = []

    def conv(path, key):
        rows.append((path + ("kernel",), key + ".weight", "conv"))
        rows.append((path + ("bias",), key + ".bias", "vec"))

    for pyr in ("pyr_a", "pyr_b", "pyr_c"):
        for k in range(6):
            for j in range(2):
                conv((pyr, f"ConvFeatBlock_{k}", f"Conv_{j}"), f"{pyr}.{k}.convs.{j}")
    for dec in ("dec_fwd", "dec_bwd", "dec_occ"):
        for k in range(5):
            for j in range(6):
                conv((f"{dec}_{k}", f"Conv_{j}"), f"{dec}.{k}.convs.{j}")
    return rows


def pwc_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """State_dict of PWCNet (PWCLearner's module) from the JAX params."""
    return from_jax(params, pwc_rows())


def pwc_jax_layout(sd: Mapping[str, torch.Tensor], template: Tree) -> Dict:
    """JAX's PWCNet tree of ``template`` from the port state_dict ``sd``
    (parameters or their gradients)."""
    return to_jax(sd, template, pwc_rows())


def raft_rows() -> List[Row]:
    """Rows of a JAX ``RAFT`` tree (flow mode) against ``models/raft.py::RAFT``:
    each encoder's ``Conv_0`` (the stem), ``ResidualBlock_k/Conv_{0,1,2}``
    (conv1, conv2 and the projection where a block has one) and ``Conv_1``
    (the output); the update block's ``BasicMotionEncoder_0/Conv_{0..4}``,
    ``SepConvGRU_0/Conv_{0..5}``, ``FlowHead_0/Conv_{0,1}`` and the mask's
    ``Conv_{0,1}``."""
    from ..models.raft import BLOCKS

    rows: List[Row] = []

    def conv(path, key):
        rows.append((path + ("kernel",), key + ".weight", "conv"))
        rows.append((path + ("bias",), key + ".bias", "vec"))

    for enc in ("fnet", "cnet"):
        conv((enc, "Conv_0"), f"{enc}.stem")
        cin = 64
        for k, (planes, stride) in enumerate(BLOCKS):
            names = ["conv1", "conv2"] + (["down"] if stride != 1 or cin != planes else [])
            for j, name in enumerate(names):
                conv((enc, f"ResidualBlock_{k}", f"Conv_{j}"), f"{enc}.blocks.{k}.{name}")
            cin = planes
        conv((enc, "Conv_1"), f"{enc}.out")
    ub = "update_block"
    for j, name in enumerate(("convc1", "convc2", "convf1", "convf2", "conv")):
        conv((ub, "BasicMotionEncoder_0", f"Conv_{j}"), f"{ub}.encoder.{name}")
    for j in range(6):
        conv((ub, "SepConvGRU_0", f"Conv_{j}"), f"{ub}.gru.convs.{j}")
    conv((ub, "FlowHead_0", "Conv_0"), f"{ub}.flow_head.conv1")
    conv((ub, "FlowHead_0", "Conv_1"), f"{ub}.flow_head.conv2")
    conv((ub, "Conv_0"), f"{ub}.mask.0")
    conv((ub, "Conv_1"), f"{ub}.mask.1")
    return rows


def raft_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """State_dict of RAFT (flow mode) from the JAX params."""
    return from_jax(params, raft_rows())


def raft_jax_layout(sd: Mapping[str, torch.Tensor], template: Tree) -> Dict:
    """JAX's RAFT tree of ``template`` from the port state_dict ``sd``
    (parameters or their gradients)."""
    return to_jax(sd, template, raft_rows())


def _bn_rows(path: Tuple[str, ...], key: str) -> List[Row]:
    """A flax BatchNorm at ``path`` of the params (``net``) and its
    ``batch_stats`` against the port's ``models/resnet.py::BatchNorm``."""
    return [(("net",) + path + ("scale",), key + ".weight", "vec"),
            (("net",) + path + ("bias",), key + ".bias", "vec"),
            (("batch_stats",) + path + ("mean",), key + ".running_mean", "vec"),
            (("batch_stats",) + path + ("var",), key + ".running_var", "vec")]


def _plain_conv(path: Tuple[str, ...], key: str) -> Row:
    return (("net",) + path + ("kernel",), key + ".weight", "conv")


def _dense_rows(path: Tuple[str, ...], key: str) -> List[Row]:
    return [(path + ("kernel",), key + ".weight", "dense"), (path + ("bias",), key + ".bias", "vec")]


def resnet_rows(num_blocks: Sequence[int] = (2, 2, 2, 2)) -> List[Row]:
    """Rows of the JAX ``Classifier``'s ResNet tree against
    ``models/resnet.py::ResNet``: the stem ``Conv_0``/``BatchNorm_0``, each
    ``BasicBlock_k``'s ``Conv_{0,1}``/``BatchNorm_{0,1}`` and, where the block
    has a projection shortcut, ``Conv_2``/``BatchNorm_2``, and ``Dense_0``."""
    rows = [_plain_conv(("Conv_0",), "conv1"), *_bn_rows(("BatchNorm_0",), "bn1")]
    k, cin = 0, 64
    for planes, n, first_stride in zip((64, 128, 256, 512), num_blocks, (1, 2, 2, 2)):
        for i in range(n):
            stride, b, key = first_stride if i == 0 else 1, f"BasicBlock_{k}", f"layers.{k}"
            for j in range(2):
                rows += [_plain_conv((b, f"Conv_{j}"), f"{key}.conv{j + 1}"),
                         *_bn_rows((b, f"BatchNorm_{j}"), f"{key}.bn{j + 1}")]
            if stride != 1 or cin != planes:
                rows += [_plain_conv((b, "Conv_2"), f"{key}.shortcut.0"),
                         *_bn_rows((b, "BatchNorm_2"), f"{key}.shortcut.1")]
            k, cin = k + 1, planes
    return rows + _dense_rows(("net", "Dense_0"), "linear")


def mobilenet_rows() -> List[Row]:
    """Rows of the JAX ``Classifier``'s MobileNetV2 tree against
    ``models/mobilenet.py::MobileNetV2``: the stem, each
    ``InvertedResidual_k``'s ``Conv_{0,1,2}``/``BatchNorm_{0,1,2}`` (the
    depthwise kernel (3, 3, 1, planes) as (planes, 1, 3, 3)) and its
    ``Conv_3``/``BatchNorm_3`` shortcut, the head's ``Conv_1``/``BatchNorm_1``
    and ``Dense_0``."""
    from ..models.mobilenet import _CFG

    rows = [_plain_conv(("Conv_0",), "conv1"), *_bn_rows(("BatchNorm_0",), "bn1")]
    k, cin = 0, 32
    for _, out_planes, num_blocks, stride in _CFG:
        for i in range(num_blocks):
            b, key = f"InvertedResidual_{k}", f"layers.{k}"
            for j in range(3):
                rows += [_plain_conv((b, f"Conv_{j}"), f"{key}.conv{j + 1}"),
                         *_bn_rows((b, f"BatchNorm_{j}"), f"{key}.bn{j + 1}")]
            if (stride if i == 0 else 1) == 1 and cin != out_planes:
                rows += [_plain_conv((b, "Conv_3"), f"{key}.shortcut.0"),
                         *_bn_rows((b, "BatchNorm_3"), f"{key}.shortcut.1")]
            k, cin = k + 1, out_planes
    rows += [_plain_conv(("Conv_1",), "conv2"), *_bn_rows(("BatchNorm_1",), "bn2")]
    return rows + _dense_rows(("net", "Dense_0"), "linear")


def _present(rows: Sequence[Row], template: Tree) -> List[Row]:
    """The rows whose tree (``net`` or ``batch_stats``) ``template`` holds."""
    return [r for r in rows if r[0][0] in template]


def resnet_state_dict(tree: Tree, num_blocks: Sequence[int] = (2, 2, 2, 2)
                      ) -> Dict[str, torch.Tensor]:
    """State_dict of ResNet (buffers included) from the JAX Classifier's
    ``{"net", "batch_stats"}``."""
    return from_jax(tree, resnet_rows(num_blocks))


def resnet_jax_layout(sd: Mapping[str, torch.Tensor], template: Tree,
                      num_blocks: Sequence[int] = (2, 2, 2, 2)) -> Dict:
    """JAX's ``{"net"[, "batch_stats"]}`` of ``template`` from the port
    state_dict ``sd`` (parameters and buffers, or gradients)."""
    return to_jax(sd, template, _present(resnet_rows(num_blocks), template))


def mobilenet_state_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    """State_dict of MobileNetV2 from the JAX Classifier's ``{"net",
    "batch_stats"}``."""
    return from_jax(tree, mobilenet_rows())


def mobilenet_jax_layout(sd: Mapping[str, torch.Tensor], template: Tree) -> Dict:
    """JAX's ``{"net"[, "batch_stats"]}`` of ``template`` from ``sd``."""
    return to_jax(sd, template, _present(mobilenet_rows(), template))


ARCH_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


def classifier_rows(arch: str) -> List[Row]:
    """The rows of the Classifier's ``arch`` (``algorithms/classifier.py``)."""
    return mobilenet_rows() if arch == "mobilenet_v2" else resnet_rows(ARCH_BLOCKS[arch])


def classifier_state_dict(tree: Tree, arch: str = "resnet18") -> Dict[str, torch.Tensor]:
    """State_dict of the Classifier's module from its JAX params."""
    return from_jax(tree, classifier_rows(arch))


def classifier_jax_layout(sd: Mapping[str, torch.Tensor], template: Tree,
                          arch: str = "resnet18") -> Dict:
    """The JAX Classifier's params tree of ``template`` from ``sd``."""
    return to_jax(sd, template, _present(classifier_rows(arch), template))


def common_rows(name: str, params: Tree) -> List[Row]:
    """Rows of a ``models/common.py`` module's JAX tree (``name``:
    ``SimpleMlp``, ``CnnEncoder``, ``CnnDecoder`` or ``CustomizableCnn``)
    against the port's: ``Dense_i`` -> ``layers.i`` (the MLP), ``Conv_i`` ->
    ``convs.i``, ``ConvTranspose_i`` -> ``convs.i`` (flipped), ``Dense_0`` ->
    ``dense``."""
    count = lambda prefix: sum(k.startswith(prefix) for k in params)
    if name == "SimpleMlp":
        return [r for i in range(count("Dense_")) for r in _dense_rows((f"Dense_{i}",),
                                                                       f"layers.{i}")]
    conv = "ConvTranspose" if name == "CnnDecoder" else "Conv"
    rows = [r for i in range(count(conv + "_")) for r in (
        ((f"{conv}_{i}", "kernel"), f"convs.{i}.weight",
         "convT" if conv == "ConvTranspose" else "conv"),
        ((f"{conv}_{i}", "bias"), f"convs.{i}.bias", "vec"))]
    return rows + (_dense_rows(("Dense_0",), "dense") if "Dense_0" in params else [])


def common_state_dict(name: str, params: Tree) -> Dict[str, torch.Tensor]:
    """State_dict of a ``models/common.py`` module from its JAX params."""
    return from_jax(params, common_rows(name, params))


def common_jax_layout(name: str, sd: Mapping[str, torch.Tensor], template: Tree) -> Dict:
    """JAX's tree of ``template`` from the port state_dict ``sd``."""
    return to_jax(sd, template, common_rows(name, template))


def _get(tree: Tree, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def from_jax(params: Tree, rows: Sequence[Row], prefix: str = "") -> Dict[str, torch.Tensor]:
    """The state_dict that ``rows`` map the JAX tree ``params`` to."""
    return {
        prefix + key: torch.from_numpy(np.array(
            _to_port(kind, np.asarray(_get(params, path), np.float32)), order="C"))
        for path, key, kind in rows
    }


def to_jax(sd: Mapping[str, torch.Tensor], template: Tree, rows: Sequence[Row],
           prefix: str = "") -> Dict:
    """The JAX tree of ``template`` (names and shapes) holding the values of
    the state_dict ``sd`` (parameters or their gradients) that ``rows`` map,
    as float32 numpy arrays."""
    out: Dict = {}
    for path, key, kind in rows:
        a = sd[prefix + key].detach().float().cpu().numpy()
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _to_jax(kind, a, np.shape(_get(template, path)))
    return out


def params_from_jax(params: Tree, prefix: str = "",
                    dim_mults: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
    """State_dict of ``models/unet.py::Unet`` from the JAX ``Unet`` params
    (any ``time_in``, ``dim_mults``, stem and output widths, the Fourier
    embedding)."""
    return from_jax(params, _table(params, dim_mults), prefix)


def flow_diffuser_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """State_dict of FlowDiffuser's module from its JAX params: the
    UnetWithWarp tree ``{"model": <unet>}`` (keys ``model.*``), or the plain
    ``Unet`` tree of the ``flow`` target (no prefix)."""
    if "model" in params:
        return params_from_jax(params["model"], prefix="model.")
    return params_from_jax(params)


def autoencoder_state_dict(params: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """State_dict of ``models/autoencoder.py::Autoencoder`` from the JAX
    Autoencoder params (``model_enc``, ``model_dec``: two UNets)."""
    return {**params_from_jax(params["model_enc"], prefix + "model_enc."),
            **params_from_jax(params["model_dec"], prefix + "model_dec.")}


def jax_layout(sd: Mapping[str, torch.Tensor], template: Tree, prefix: str = "model.",
               dim_mults: Optional[Sequence[int]] = None) -> Dict:
    """The JAX ``Unet`` tree of ``template`` (names and shapes) holding the
    values of the port state_dict ``sd`` (parameters or their gradients),
    as float32 numpy arrays."""
    return to_jax(sd, template, _table(template, dim_mults), prefix)


def _completer_rows(params: Tree) -> List[Row]:
    """Rows of JAX's FlowCompleter tree against ``FlowCompleterNet``."""
    return [(("net", "Unet_0") + path, "net." + key, kind)
            for path, key, kind in _table(params["net"]["Unet_0"])] + [
        (("null_embedding",), "null_embedding", "vec")]


def flow_completer_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """State_dict of FlowCompleter's module from its JAX params."""
    return from_jax(params, _completer_rows(params))


def flow_completer_jax_layout(sd: Mapping[str, torch.Tensor], template: Tree) -> Dict:
    """JAX's FlowCompleter tree of ``template`` from the port state_dict
    ``sd`` (parameters or their gradients)."""
    return to_jax(sd, template, _completer_rows(template))


def autoencoder_jax_layout(sd: Mapping[str, torch.Tensor], template: Tree,
                           prefix: str = "") -> Dict:
    """The JAX Autoencoder tree of ``template`` from the port state_dict
    ``sd`` (the inverse of :func:`autoencoder_state_dict`)."""
    return {name: jax_layout(sd, template[name], prefix + name + ".")
            for name in ("model_enc", "model_dec")}


__all__ = ["autoencoder_jax_layout", "autoencoder_state_dict", "classifier_jax_layout",
           "classifier_rows", "classifier_state_dict", "common_jax_layout", "common_rows",
           "common_state_dict", "filter_codec_rows", "mobilenet_jax_layout", "mobilenet_rows",
           "mobilenet_state_dict", "resnet_jax_layout", "resnet_rows", "resnet_state_dict",
           "flow_completer_jax_layout", "flow_completer_state_dict",
           "flow_diffuser_state_dict", "flow_learner_jax_layout", "flow_learner_state_dict",
           "from_jax", "jax_layout", "linear_attention_rows", "params_from_jax", "pwc_jax_layout",
           "pwc_rows", "pwc_state_dict", "raft_jax_layout", "raft_rows", "raft_state_dict",
           "to_jax"]
