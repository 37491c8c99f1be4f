"""Weights carried into the port.

The port's module names are the reference ``state_dict`` keys, so a
reference ``.pth`` loads as it is (after stripping a ``module.`` prefix), and
the JAX parameter tree maps onto the port by the inverse of the JAX package's
torch importer: flax conv kernels ``(kh, kw, I, O)`` become torch
``(O, I, kh, kw)``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _encoder_names(enc_type: str):
    """flax submodule name -> torch prefix, for one BasicEncoder."""
    names = {"Conv_0": "conv1"}
    blocks = ["layer1.0", "layer1.1", "layer2.0", "layer2.1"]
    if enc_type == "LR":
        blocks += ["layer3.0", "layer3.1"]
    for i, b in enumerate(blocks):
        names[f"ResidualBlock_{i}"] = b
    names["Conv_1"] = "conv2"
    return names


_BLOCK_CONVS = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "downsample.0"}
_TWO_CONV = {"conv1": "0", "conv2": "2"}


def jax_params_to_state_dict(params: Dict, enc_type: str = "HR") -> Dict:
    """JAX ``{'params': ...}`` tree (numpy leaves) -> port ``state_dict``."""
    tree = params["params"] if "params" in params else params
    sd = {}

    def conv(prefix, leaf):
        sd[f"{prefix}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(leaf["kernel"], np.float32)
                                 .transpose(3, 2, 0, 1)))
        if "bias" in leaf:
            sd[f"{prefix}.bias"] = torch.from_numpy(
                np.asarray(leaf["bias"], np.float32).copy())

    for enc in ("fnet", "cnet"):
        for flax_name, torch_name in _encoder_names(enc_type).items():
            sub = tree[enc][flax_name]
            if flax_name.startswith("ResidualBlock"):
                for cname, leaf in sub.items():
                    conv(f"{enc}.{torch_name}.{_BLOCK_CONVS[cname]}", leaf)
            else:
                conv(f"{enc}.{torch_name}", sub)
    for name, sub in tree["update_block"].items():
        if name == "gru":
            for g in ("convz", "convr", "convq"):
                conv(f"update_block.gru.{g}", sub[g])
        else:
            for cname, idx in _TWO_CONV.items():
                conv(f"update_block.{name}.{idx}", sub[cname])
    return sd


def load_jax_params(model: torch.nn.Module, params: Dict) -> torch.nn.Module:
    """Load a JAX ``{'params': ...}`` tree (numpy arrays) into the port's
    ``RAFT``; every key must match."""
    sd = jax_params_to_state_dict(params, model.encoder_type)
    model.load_state_dict(sd, strict=True)
    return model


def load_reference_checkpoint(path, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference ``.pth`` (optionally DataParallel-prefixed) into the
    port's ``RAFT``."""
    sd = torch.load(path, map_location="cpu")
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
    return model
