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
:func:`flow_completer_jax_layout`.
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


__all__ = ["autoencoder_jax_layout", "autoencoder_state_dict", "filter_codec_rows",
           "flow_completer_jax_layout", "flow_completer_state_dict",
           "flow_diffuser_state_dict", "flow_learner_jax_layout", "flow_learner_state_dict",
           "from_jax", "jax_layout", "linear_attention_rows", "params_from_jax", "to_jax"]
