"""The port's launch layer against the reference's, on the CPU and without
a process group: partition specs on every parameter (`Transformer.specs`,
`spec_tree`), `sanitize_spec` and `state_shardings` at the production
mesh shapes, abstract parameters, `build_cell` for every runnable
(arch x shape) cell, and the mesh helpers.

The reference stacks each scan group's layers on a leading axis whose
spec entry is None; the port keeps one block per layer, so the
reference's trees are unstacked here (the leading None dropped) and
named as the port names its parameters.  The reference's mesh is a
`jax.sharding.AbstractMesh` of the production shape and the port's the
matching name-to-size mapping: neither allocates or needs devices.
Adafactor factors the second moment of a stacked leaf over its trailing
two axes, layer axis included, so for a leaf that is 1-D in one layer
the two states differ in structure (`state_from_reference` refuses them
too); those leaves, and only those, are left out of that comparison.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.launch.specs as RS  # noqa: E402
import repro.models as RM  # noqa: E402
import repro.optim as RO  # noqa: E402
import repro.train as RT  # noqa: E402
import repro_torch.optim as TO  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import (  # noqa: E402
    ARCH_IDS, SHAPES, cell_is_runnable,
)
from repro_torch.launch import (  # noqa: E402
    batch_axes, make_host_mesh, mesh_shape, set_mesh,
)
from repro_torch.launch.specs import (  # noqa: E402
    build_cell, sanitize_spec, state_shardings,
)
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models.layers import current_mesh, spec_tree  # noqa: E402
from repro_torch.models.model import model_params, param_specs  # noqa: E402

PRODUCTION = {"16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
         if cell_is_runnable(get_config(a), s)[0]]


def _abstract_mesh(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _is_leaf(x):
    return isinstance(x, (P, NamedSharding, jax.ShapeDtypeStruct))


def _unstack(tree, cfg, leaf_fn):
    """{port name: leaf_fn(leaf, stacked)} of a reference parameter-shaped
    tree: the stacked groups split into per-layer names."""
    out = {}

    def put(prefix, sub, stacked):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                sub, is_leaf=_is_leaf)[0]:
            name = prefix + ".".join(str(getattr(k, "key", getattr(
                k, "idx", k))) for k in path)
            out[name] = leaf_fn(leaf, stacked)

    put("", {k: v for k, v in tree.items() if k not in ("groups", "encoder")},
        False)
    layer = 0
    for g, (unit, repeats) in enumerate(cfg.scan_groups()):
        for _ in range(repeats):
            for i in range(len(unit)):
                put(f"blocks.{layer}.", tree["groups"][g][f"b{i}"], True)
                layer += 1
    if "encoder" in tree:
        for j in range(cfg.encoder_layers):
            put(f"encoder.blocks.{j}.", tree["encoder"]["blocks"]["b0"], True)
        put("encoder.final_norm.", tree["encoder"]["final_norm"], False)
    return out


def _spec(leaf, stacked):
    spec = tuple(leaf.spec if isinstance(leaf, NamedSharding) else leaf)
    if stacked:
        assert spec[0] is None, spec
        return spec[1:]
    return spec


def _factored_spec(leaf, stacked):
    """A reference Adafactor leaf's spec per layer; None where its stacked
    layer axis was factored away (a 1-D leaf's column vector)."""
    spec = tuple(leaf.spec)
    if not stacked:
        return spec
    return spec[1:] if spec and spec[0] is None else None


@pytest.mark.parametrize("model_axis", (16, 2))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_tree_matches_reference(arch, model_axis):
    cfg = get_config(arch)
    rcfg = RC.get_config(arch)
    want = _unstack(RM.Transformer(rcfg, model_axis=model_axis).specs(),
                    rcfg, _spec)
    got = Transformer(cfg, model_axis=model_axis).specs()
    assert got == want
    assert got == param_specs(cfg, model_axis=model_axis)
    # the nested tree holds the same specs
    tree = spec_tree(model_params(cfg, model_axis))
    assert tree["embed"] == got["embed"] == ("model", "data")
    assert tree["blocks"][0]["ln1"]["scale"] == ("model",)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_reference(arch):
    cfg, rcfg = get_config(arch), RC.get_config(arch)
    want = _unstack(RM.Transformer(rcfg).abstract(), rcfg,
                    lambda a, st: (tuple(a.shape[1:] if st else a.shape),
                                   str(a.dtype)))
    model = Transformer(cfg)
    got = model.abstract()
    assert all(t.device.type == "meta" for t in got.values())
    assert {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in got.items()} == want
    assert model.num_params == RM.Transformer(rcfg).num_params


SANITIZE = [
    (("data", "model"), (3072, 8192)),
    (("model", "data"), (51865, 384)),      # whisper's vocab: not 16-way
    (("model", None), (24, 128)),
    ((("pod", "data"), None), (64, 7)),
    ((("pod", "data"), None), (16, 7)),
    (("data", "model", None), (8, 32)),     # more entries than dims
    ((), (5, 5)),
]


@pytest.mark.parametrize(("spec", "shape", "mesh"), [
    (spec, shape, mesh) for spec, shape in SANITIZE for mesh in PRODUCTION
    if "pod" in PRODUCTION[mesh] or "pod" not in str(spec)])
def test_sanitize_spec_matches_reference(spec, shape, mesh):
    sizes = PRODUCTION[mesh]
    want = RS.sanitize_spec(P(*spec), shape, _abstract_mesh(sizes))
    assert sanitize_spec(spec, shape, sizes) == tuple(want)


def test_sanitize_spec_drops_missing_dims():
    assert sanitize_spec(("data", "model"), (4, 4), {"data": 2}) == (
        "data", None)


@pytest.mark.parametrize("optimizer", ("adamw", "sgdm", "adafactor"))
@pytest.mark.parametrize("mesh", list(PRODUCTION))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_shardings_match_reference(arch, mesh, optimizer):
    sizes = PRODUCTION[mesh]
    cfg, rcfg = get_config(arch), RC.get_config(arch)
    rmodel = RM.Transformer(rcfg)
    r_abs, r_specs = rmodel.abstract(), rmodel.specs()
    r_opt = jax.eval_shape(
        lambda p: RT.init_train_state(p, RO.make_optimizer(optimizer)),
        r_abs)["opt"]
    ref = RS.state_shardings(_abstract_mesh(sizes), r_abs, r_specs, r_opt)

    model = Transformer(cfg)
    p_abs, specs = model.abstract(), model.specs()
    got = state_shardings(sizes, p_abs, specs,
                          TO.make_optimizer(optimizer).init(p_abs))

    assert got["params"] == _unstack(ref["params"], rcfg, _spec)
    assert got["step"] == tuple(ref["step"].spec) == ()
    assert got["opt"]["count"] == tuple(ref["opt"]["count"].spec) == ()
    assert set(got["opt"]) == set(ref["opt"])
    if "m" in got["opt"]:
        assert got["opt"]["m"] == _unstack(ref["opt"]["m"], rcfg, _spec)
    if optimizer == "sgdm":
        return
    # the second moment: adafactor's leaves are {"vr", "vc"} or {"v"}
    ref_v = _unstack(ref["opt"]["v"], rcfg, _spec if optimizer == "adamw"
                     else _factored_spec)
    if optimizer == "adamw":
        assert got["opt"]["v"] == ref_v
        return
    skipped = set()
    for name, entry in got["opt"]["v"].items():
        if "vr" in entry:
            assert entry == {"vr": ref_v[f"{name}.vr"],
                             "vc": ref_v[f"{name}.vc"]}, name
        elif f"{name}.v" in ref_v:
            assert entry == {"v": ref_v[f"{name}.v"]}, name
        else:   # factored over the stacked layer axis in the reference
            skipped.add(name)
    assert all(p_abs[n].dim() == 1 and n.startswith(("blocks.", "encoder."))
               for n in skipped), skipped


@pytest.mark.parametrize(("arch", "shape_name"), CELLS)
def test_cell_builds_abstractly(arch, shape_name):
    """Every runnable cell's step, abstract arguments and shardings build
    without allocating and without a process group."""
    import torch.distributed as dist

    cfg = get_config(arch)
    sizes = PRODUCTION["16x16"]
    cell = build_cell(cfg, shape_name, sizes, device="cpu")
    S, B, mode = SHAPES[shape_name]
    assert cell.mode == mode and callable(cell.fn)
    assert cell.meta["num_params"] > 0 and cell.meta["dp"] == ("data",)

    def leaves(tree, spec_leaf):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v, spec_leaf)]
        if isinstance(tree, list) or (isinstance(tree, tuple)
                                      and not spec_leaf):
            return [x for v in tree for x in leaves(v, spec_leaf)]
        return [] if tree is None else [tree]

    args = leaves(cell.args_abs, False)
    specs = [s for a in cell.in_shardings for s in leaves(a, True)]
    assert len(args) == len(specs)
    tensors = [a for a in args if torch.is_tensor(a)]
    assert all(t.device.type == "meta" for t in tensors)
    assert len(tensors) >= len(args) - 1     # the train state's step
    for a, s in zip(args, specs):
        assert isinstance(s, tuple)
        if torch.is_tensor(a):
            assert len(s) <= a.dim()
            assert sanitize_spec(s, tuple(a.shape), sizes) == s
    tokens = (cell.args_abs[1]["tokens"] if mode != "decode"
              else cell.args_abs[2])
    assert tokens.shape[0] == B
    assert not dist.is_initialized()


def test_mesh_helpers_without_a_process_group():
    import torch.distributed as dist

    sizes = PRODUCTION["2x16x16"]
    assert mesh_shape(sizes) == sizes
    assert batch_axes(sizes) == ("pod", "data")
    assert batch_axes(PRODUCTION["16x16"]) == ("data",)
    assert current_mesh() is None
    with set_mesh(sizes):
        assert current_mesh() is sizes
        with set_mesh(None):
            assert current_mesh() is None
        assert current_mesh() is sizes
    assert current_mesh() is None
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_host_mesh(2, 2, device_type="cpu")


def test_mapping_mesh_does_not_run():
    from repro_torch.models import forward

    cfg = dataclasses.replace(get_config("llama3.2-3b"), num_layers=1)
    with set_mesh(PRODUCTION["16x16"]), pytest.raises(TypeError,
                                                      match="DeviceMesh"):
        forward({}, cfg, {"tokens": [[0]]}, dp=("data",))
