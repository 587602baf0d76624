"""Abstract inputs and shardings for every (arch x shape x mesh) cell.

`build_cell(cfg, shape_name, mesh)` returns what a launcher needs: the
step callable, abstract arguments (meta tensors of the global shapes:
nothing is allocated) and their shardings, as the reference's
`launch/specs.py` does.  A sharding is a partition spec as a plain tuple
(`models.layers`), sanitized against the mesh: a mesh dim that does not
divide an array's dim is dropped to replication there (whisper's 51865
vocab on a 16-way "model" dim).  `mesh` is a `DeviceMesh` or a
name-to-size mapping; building a cell starts no process group.

A cell's `fn` is the sharded step: it runs under `launch.mesh.set_mesh`
of a `DeviceMesh` of these dims, in every rank, on the rank's blocks of
the arguments (`models.sharded.shard_params`, `local_block`).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.registry import SHAPES
from ..models.config import ModelConfig
from ..models.layers import DTYPES
from ..models.model import Transformer, decode_step, forward, init_cache
from ..models.sharded import cache_spec, sanitize_spec
from ..optim import cosine_schedule, make_optimizer
from ..train import init_train_state, make_train_step
from .mesh import batch_axes

__all__ = ["build_cell", "sanitize_spec", "state_shardings", "Cell"]


def state_shardings(mesh, params_abs: dict, param_specs: dict,
                    opt_abs: dict) -> dict:
    """Shardings of a train state {params, opt, step}: the optimizer's
    moments follow the params' layout; Adafactor's factored vectors
    drop the reduced dim.  `params_abs` and `param_specs` are flat dicts
    by parameter name; `opt_abs` is the optimizer's state."""
    p_sh = {k: sanitize_spec(param_specs[k], a.shape, mesh)
            for k, a in params_abs.items()}

    def second_moment(k, v):
        spec = tuple(param_specs[k])
        if isinstance(v, dict) and "vr" in v:
            vc = spec[:-2] + spec[-1:] if len(spec) >= 2 else ()
            return {"vr": sanitize_spec(spec[:-1], v["vr"].shape, mesh),
                    "vc": sanitize_spec(vc, v["vc"].shape, mesh)}
        if isinstance(v, dict):
            return {"v": sanitize_spec(spec, v["v"].shape, mesh)}
        return sanitize_spec(spec, v.shape, mesh)   # adamw: as the param

    def opt_entry(name, sub):
        if name == "m":
            return p_sh
        if name == "count":
            return ()
        if name == "v":
            return {k: second_moment(k, v) for k, v in sub.items()}
        raise KeyError(name)

    return {"params": p_sh,
            "opt": {k: opt_entry(k, v) for k, v in opt_abs.items()},
            "step": ()}


def _batch_abs_and_sh(cfg: ModelConfig, B: int, S: int, mesh, dp,
                      with_labels: bool):
    abs_, sh = {}, {}

    def add(name, shape, dtype, spec):
        abs_[name] = torch.empty(shape, dtype=dtype, device="meta")
        sh[name] = sanitize_spec(spec, shape, mesh)

    add("tokens", (B, S), torch.int32, (dp, None))
    if with_labels:
        add("labels", (B, S), torch.int32, (dp, None))
    if cfg.mrope_sections is not None:
        add("positions", (B, S, 3), torch.int32, (dp, None, None))
    if cfg.encoder_layers:
        add("frames", (B, cfg.encoder_seq, cfg.d_model), DTYPES[cfg.dtype],
            (dp, None, None))
    return abs_, sh


def _cache_shardings(cfg: ModelConfig, cache_abs: dict, mesh, dp) -> dict:
    """The reference's name-based rules for the decode state
    (`models.sharded.cache_spec`), a layer at a time (the port keeps no
    stacked layer axis)."""
    memory = cache_abs["memory"]
    return {
        "layers": [{k: cache_spec(k, tuple(a.shape), mesh, dp)
                    for k, a in layer.items()}
                   for layer in cache_abs["layers"]],
        "step": (),
        "memory": (None if memory is None else
                   cache_spec("memory", tuple(memory.shape), mesh, dp)),
    }


@dataclasses.dataclass
class Cell:
    fn: object            # the step callable
    args_abs: tuple       # abstract arguments (meta tensors)
    in_shardings: tuple   # sanitized spec tuples mirroring args_abs
    out_shardings: object
    donate: tuple
    mode: str
    meta: dict


def build_cell(cfg: ModelConfig, shape_name: str, mesh,
               model_axis: int = 16, device="cuda") -> Cell:
    """The cell of `cfg` at `SHAPES[shape_name]` (or at `shape_name`
    itself, an (S, B, mode) tuple) on `mesh` (module docstring); its
    step runs on `device` (the card unless "cpu" is asked for)."""
    S, B, mode = (SHAPES[shape_name] if isinstance(shape_name, str)
                  else tuple(shape_name))
    dp = batch_axes(mesh)
    model = Transformer(cfg, model_axis=model_axis)
    params_abs = model.abstract()
    specs = model.specs()
    p_sh = {k: sanitize_spec(specs[k], a.shape, mesh)
            for k, a in params_abs.items()}
    meta = {"num_params": model.num_params, "dp": dp, "mode": mode}

    if mode == "train":
        opt = make_optimizer(cfg.optimizer)
        lr = cosine_schedule(3e-4, 2000, 100_000)
        state_abs = init_train_state(params_abs, opt)
        st_sh = state_shardings(mesh, params_abs, specs, state_abs["opt"])
        batch_abs, batch_sh = _batch_abs_and_sh(cfg, B, S, mesh, dp, True)
        fn = make_train_step(cfg, opt, lr, dp=dp, device=device)
        return Cell(fn=fn, args_abs=(state_abs, batch_abs),
                    in_shardings=(st_sh, batch_sh),
                    out_shardings=(st_sh, None), donate=(0,), mode=mode,
                    meta=meta)

    if mode == "prefill":
        batch_abs, batch_sh = _batch_abs_and_sh(cfg, B, S, mesh, dp, False)
        return Cell(fn=lambda p, b: forward(p, cfg, b, dp=dp),
                    args_abs=(params_abs, batch_abs),
                    in_shardings=(p_sh, batch_sh), out_shardings=None,
                    donate=(), mode=mode, meta=meta)

    # decode: one new token against a seq_len-deep cache
    frames_abs = (torch.empty((B, cfg.encoder_seq, cfg.d_model),
                              dtype=DTYPES[cfg.dtype], device="meta")
                  if cfg.encoder_layers else None)
    cache_abs = init_cache(params_abs, cfg, batch=B, max_len=S,
                           frames=frames_abs, dp=None)
    cache_sh = _cache_shardings(cfg, cache_abs, mesh, dp)
    tok_abs = torch.empty((B,), dtype=torch.int32, device="meta")
    return Cell(fn=lambda p, c, t: decode_step(p, cfg, c, t, dp=dp),
                args_abs=(params_abs, cache_abs, tok_abs),
                in_shardings=(p_sh, cache_sh,
                              sanitize_spec((dp,), (B,), mesh)),
                out_shardings=(None, cache_sh), donate=(1,), mode=mode,
                meta=meta)
