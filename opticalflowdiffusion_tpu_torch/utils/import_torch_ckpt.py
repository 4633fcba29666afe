"""Weights of the reference PyTorch Lightning FlowDiffuser (JAX
``utils/import_torch_ckpt.py``: ``flow_diffuser_params_from_lightning``,
``load_torch_state_dict``).

The port's UNet uses the reference UNet's keys (``utils/weights.py``), so
importing is a matter of prefixes: the reference registers its UNet as
``self.unet`` (its weights live under ``unet.*``, aliased again under
``model.model.model.*``, which is not read), and ``target`` chooses the
wrapper: ``target`` and ``joint`` run ``UnetWithWarp`` (the UNet under
``model.``), ``flow`` the bare UNet.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

PREFIX = "unet."


def flow_diffuser_params_from_lightning(state_dict: Mapping,
                                        target: str = "joint") -> Dict[str, torch.Tensor]:
    """A FlowDiffuser Lightning state_dict (or a whole checkpoint holding one
    under ``state_dict``) -> the state_dict of the port's FlowDiffuser
    module for ``target``."""
    sd = state_dict.get("state_dict", state_dict)
    if any(k.startswith(PREFIX) for k in sd):
        unet = {k[len(PREFIX):]: v for k, v in sd.items() if k.startswith(PREFIX)}
    else:
        unet = dict(sd)
    if target in ("target", "joint"):
        return {"model." + k: v for k, v in unet.items()}
    if target == "flow":
        return unet
    raise ValueError(f"target {target!r} is not joint, target or flow")


def load_torch_state_dict(path) -> Mapping:
    """Unpickle a torch or Lightning ``.ckpt`` / ``.pt`` on the CPU: its
    ``state_dict`` (a Lightning checkpoint also pickles objects other than
    tensors, so this is not ``weights_only``; load only trusted files)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj.get("state_dict", obj) if isinstance(obj, dict) else obj


__all__ = ["flow_diffuser_params_from_lightning", "load_torch_state_dict"]
