"""Weight bridge: a flax UNet parameter tree (as numpy) -> a torch state_dict.

The inverse of the per-block tables of the JAX package's
``utils/import_torch_ckpt.py``: the state_dict uses the reference PyTorch
UNet's keys, which are also the keys of ``models/unet.py`` here.  Conv
kernels go from HWIO to OIHW, dense kernels are transposed, and the
Downsample 1x1 conv's input channels go from the JAX order (dy, dx, c) back
to the pixel-unshuffle order (c, dy, dx).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

Tree = Mapping[str, object]


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _conv(sd: Dict, p: Tree, key: str) -> None:
    sd[key + ".weight"] = _f32(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[key + ".bias"] = _f32(p["bias"])


def _dense(sd: Dict, p: Tree, key: str) -> None:
    sd[key + ".weight"] = _f32(np.asarray(p["kernel"]).T)
    sd[key + ".bias"] = _f32(p["bias"])


def _gain(g) -> torch.Tensor:
    return _f32(np.asarray(g).reshape(1, -1, 1, 1))


def _resnet_block(sd: Dict, p: Tree, key: str) -> None:
    for flax_name, name in (("Block_0", "block1"), ("Block_1", "block2")):
        _conv(sd, p[flax_name]["WSConv_0"], f"{key}.{name}.proj")
        gn = p[flax_name]["GroupNorm_0"]
        sd[f"{key}.{name}.norm.weight"] = _f32(gn["scale"])
        sd[f"{key}.{name}.norm.bias"] = _f32(gn["bias"])
    if "Dense_0" in p:
        _dense(sd, p["Dense_0"], key + ".mlp.1")
    if "Conv_0" in p:
        _conv(sd, p["Conv_0"], key + ".res_conv")


def _linear_attention_block(sd: Dict, p: Tree, key: str) -> None:
    sd[key + ".fn.norm.g"] = _gain(p["prenorm_g"])
    sd[key + ".fn.fn.to_qkv.weight"] = _f32(np.asarray(p["qkv_kernel"]).T[:, :, None, None])
    sd[key + ".fn.fn.to_out.0.weight"] = _f32(np.asarray(p["out_kernel"]).T[:, :, None, None])
    sd[key + ".fn.fn.to_out.0.bias"] = _f32(p["out_bias"])
    sd[key + ".fn.fn.to_out.1.g"] = _gain(p["postnorm_g"])


def _mid_attention(sd: Dict, params: Tree, key: str) -> None:
    sd[key + ".fn.norm.g"] = _gain(params["PreNormResidual_0"]["ChanLayerNorm_0"]["g"])
    _conv(sd, params["Attention_0"]["Conv_0"], key + ".fn.fn.to_qkv")
    _conv(sd, params["Attention_0"]["Conv_1"], key + ".fn.fn.to_out")


def _downsample(sd: Dict, p: Tree, key: str) -> None:
    w = np.asarray(p["Conv_0"]["kernel"])[0, 0].T          # (O, 4C), JAX order
    four_c = w.shape[1]
    C = four_c // 4
    idx = np.arange(four_c)
    p1, p2, c = idx // (2 * C), (idx // C) % 2, idx % C
    out = np.empty_like(w)
    out[:, c * 4 + p1 * 2 + p2] = w
    sd[key + ".1.weight"] = _f32(out[:, :, None, None])
    sd[key + ".1.bias"] = _f32(p["Conv_0"]["bias"])


def params_from_jax(params: Tree, prefix: str = "",
                    dim_mults: Sequence[int] = (1, 2, 4, 8)) -> Dict[str, torch.Tensor]:
    """State_dict of ``models/unet.py::Unet`` from the JAX ``Unet`` params."""
    R = len(dim_mults)
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, params["Conv_0"], "init_conv")
    _dense(sd, params["Dense_0"], "time_mlp.1")
    _dense(sd, params["Dense_1"], "time_mlp.3")
    rb, lab, conv = 0, 0, 1
    for i in range(R):
        for j in range(2):
            _resnet_block(sd, params[f"ResnetBlock_{rb}"], f"downs.{i}.{j}")
            rb += 1
        _linear_attention_block(sd, params[f"LinearAttentionBlock_{lab}"], f"downs.{i}.2")
        lab += 1
        if i < R - 1:
            _downsample(sd, params[f"Downsample_{i}"], f"downs.{i}.3")
        else:
            _conv(sd, params[f"Conv_{conv}"], f"downs.{i}.3")
            conv += 1
    _resnet_block(sd, params[f"ResnetBlock_{rb}"], "mid_block1")
    rb += 1
    _mid_attention(sd, params, "mid_attn")
    _resnet_block(sd, params[f"ResnetBlock_{rb}"], "mid_block2")
    rb += 1
    for j in range(R):
        for k in range(2):
            _resnet_block(sd, params[f"ResnetBlock_{rb}"], f"ups.{j}.{k}")
            rb += 1
        _linear_attention_block(sd, params[f"LinearAttentionBlock_{lab}"], f"ups.{j}.2")
        lab += 1
        if j < R - 1:
            _conv(sd, params[f"Upsample_{j}"]["Conv_0"], f"ups.{j}.3.1")
        else:
            _conv(sd, params[f"Conv_{conv}"], f"ups.{j}.3")
            conv += 1
    _resnet_block(sd, params[f"ResnetBlock_{rb}"], "final_res_block")
    _conv(sd, params[f"Conv_{conv}"], "final_conv")
    return {prefix + k: v for k, v in sd.items()}


def flow_diffuser_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """State_dict of ``algorithms/flow_diffuser.py::UnetWithWarp`` from the
    JAX UnetWithWarp params (tree ``{"model": <unet>}``)."""
    return params_from_jax(params["model"], prefix="model.")


__all__ = ["params_from_jax", "flow_diffuser_state_dict"]
