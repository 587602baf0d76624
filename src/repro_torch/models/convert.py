"""Carry the reference package's parameters, decode caches and train
states into the port, so both compute on the same weights and state.

The reference stacks each scan group's layers on a leading `repeats`
axis (``tree["groups"][g]["b{i}"]``); the port keeps one block per
layer.  The converters split that axis layer by layer, in
`ModelConfig.scan_groups` order (behind the replica axis R of a
decentralized state); an encoder-decoder's encoder blocks, stacked on
one axis of `encoder_layers` (``tree["encoder"]["blocks"]["b0"]``), are
split the same way.  They take nested dicts and lists of numpy arrays
(bfloat16 arrays included) and import nothing of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.options import resolve_device
from .config import ModelConfig
from .model import Transformer, flat_tree

__all__ = ["params_from_reference", "cache_from_reference",
           "state_from_reference"]


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # exact in f32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _layer(tree, index: int, axis: int = 0):
    if isinstance(tree, dict):
        return {k: _layer(v, index, axis) for k, v in tree.items()}
    return np.take(np.asarray(tree), index, axis=axis)


def _unstack(groups, cfg: ModelConfig, axis: int = 0) -> list:
    """The per-layer trees of the reference's stacked scan groups, whose
    layer axis is `axis`."""
    layers = []
    for g_idx, (unit, repeats) in enumerate(cfg.scan_groups()):
        for r in range(repeats):
            for i in range(len(unit)):
                layers.append(_layer(groups[g_idx][f"b{i}"], r, axis))
    return layers


def _per_layer(tree: dict, cfg: ModelConfig, axis: int = 0) -> dict:
    """A reference tree with its stacked layers split into the port's
    lists: "groups" into "blocks", and the encoder's stacked blocks."""
    out = {k: v for k, v in tree.items() if k != "groups"} | {
        "blocks": _unstack(tree["groups"], cfg, axis)}
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = enc | {"blocks": [
            _layer(enc["blocks"]["b0"], r, axis)
            for r in range(cfg.encoder_layers)]}
    return out


def params_from_reference(tree: dict, cfg: ModelConfig,
                          device="cuda") -> Transformer:
    """The port's `Transformer` holding the reference parameter tree
    `tree` (``Transformer(cfg).init(key)`` of the reference, as numpy),
    on `device` (the card unless "cpu" is asked for)."""
    dev = resolve_device(device)
    values = dict(flat_tree(_per_layer(tree, cfg)))
    model = Transformer(cfg)
    names = dict(model.named_parameters())
    if set(values) != set(names):
        raise ValueError(
            f"parameter trees differ: missing "
            f"{sorted(set(names) - set(values))}, unknown "
            f"{sorted(set(values) - set(names))}")
    model.to_empty(device=dev)
    for name, param in model.named_parameters():
        src = _tensor(values[name])
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                             f"{tuple(param.shape)}")
        param.data.copy_(src.to(param.dtype))
    return model


def cache_from_reference(cache: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The port's decode cache (`models.init_cache` layout) holding the
    reference's `init_cache` / `decode_step` cache, on `device`: the
    layers' state, the step and an encoder-decoder's memory."""
    dev = resolve_device(device)
    layers = [{k: _tensor(v).to(dev) for k, v in layer.items()}
              for layer in _unstack(cache["groups"], cfg)]
    memory = cache.get("memory")
    return {"layers": layers, "step": int(np.asarray(cache["step"])),
            "memory": None if memory is None else _tensor(memory).to(dev)}


def _params_like(tree: dict, cfg: ModelConfig, names, axis: int,
                 dev) -> dict:
    """A reference tree shaped like the parameters (the parameters, an
    optimizer moment, residuals) as the port's flat dict of tensors."""
    values = dict(flat_tree(_per_layer(tree, cfg, axis)))
    if set(values) != set(names):
        raise ValueError(
            f"parameter trees differ: missing "
            f"{sorted(set(names) - set(values))}, unknown "
            f"{sorted(set(values) - set(names))}")
    return {name: _tensor(values[name]).to(dev) for name in names}


def state_from_reference(tree: dict, cfg: ModelConfig,
                         device="cuda") -> dict:
    """The port's train state (`train.init_train_state` or
    `init_decentralized_state` layout) holding a reference train state
    `tree` (as numpy), on `device` (the card unless "cpu" is asked for):
    params, the optimizer's moments and count, step, and the residuals
    and prev_grads a decentralized state may carry.  A decentralized
    state's leaves carry the replica axis R first and the scan groups'
    layer axis second.

    The moments must be elementwise (adamw, sgdm).  The reference's
    adafactor factors its second moment over the trailing two axes of
    each stacked group leaf, layer axis included, which no per-layer
    state reproduces: its leaves name no parameter, and it raises."""
    dev = resolve_device(device)
    names = [n for n, _ in Transformer(cfg).named_parameters()]
    stacked = np.ndim(tree["params"]["embed"]) == 3
    axis = 1 if stacked else 0
    conv = lambda t: _params_like(t, cfg, names, axis, dev)
    state = {"params": conv(tree["params"]), "opt": {},
             "step": int(np.asarray(tree["step"]))}
    for k, v in tree["opt"].items():
        state["opt"][k] = _tensor(v).to(dev) if k == "count" else conv(v)
    for k in ("residuals", "prev_grads"):
        if k in tree:
            state[k] = conv(tree[k])
    return state
