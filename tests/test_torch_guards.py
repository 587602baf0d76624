"""The port's boundaries: it imports neither jax nor the reference
package, runs on the card unless asked for the CPU, and refuses what it
has not ported."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(("jax.", "repro.")))
assert len(names) >= 20, names
assert not bad, bad
print(len(names))
"""


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_sources_name_no_reference_import():
    for path in (SRC / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for bad in ("import jax", "from jax", "import repro\n", "from repro.",
                    "from repro import", "import repro."):
            assert bad not in text, (path, bad)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-CUDA guards do not apply")


def test_entry_points_raise_without_cuda(no_cuda, rgg500, x0_500):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.multiscale_gossip(rgg500, x0_500)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.execute_plan(P.build_plan(rgg500), x0_500,
                       options=P.ExecOptions(backend="ref"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.synchronous_multiscale(rgg500, x0_500)
    nbr, deg, n_nodes, _ = P.batched_graphs([rgg500])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.gossip_until(x0_500[None], nbr, deg, n_nodes, eps=1e-3,
                       backend="ref")


def test_cuda_backend_on_cpu_raises():
    with pytest.raises(ValueError, match="needs device='cuda'"):
        P.ExecOptions(backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        P.ExecOptions(backend="lax", device="cpu")
    # per-tick runs on the CPU with the plain backend, and its "cuda"
    # branch needs the card like the presampled one
    assert P.ExecOptions(schedule="per_tick", device="cpu",
                         backend="ref").schedule == "per_tick"
    with pytest.raises(ValueError, match="needs device='cuda'"):
        P.ExecOptions(schedule="per_tick", device="cpu", backend="cuda")


@pytest.mark.parametrize("failures,cost", [
    (P.FailureModel(churn_fraction=0.1), None),
    (P.FailureModel(straggler_fraction=0.1), None),
    (P.FailureModel(regional_radius=0.2), None),
    (P.FailureModel(drop_fraction=0.1), None),
    (None, P.CostModel(hop_energy=(1.0, 2.0))),
])
def test_unported_scenarios_raise(rgg500, x0_500, failures, cost):
    """What the engine does not run raises, as the reference's does: a
    scenario in eps-oracle mode (its event times are fractions of a
    fixed tick budget) and a per-edge hop_energy (closed-form pricing
    only)."""
    with pytest.raises(ValueError, match="fixed_ticks_scale > 0|per-edge"):
        P.multiscale_gossip(
            rgg500, x0_500, failures=failures, cost=cost,
            options=P.ExecOptions(backend="ref", device="cpu"))


def test_model_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import Transformer, params_from_reference
    from repro_torch.serve import Generator

    cfg = reduce_config(get_config("rwkv6-3b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer(cfg).init(seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_reference({"groups": []}, cfg)
    model = Transformer(cfg).init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Generator(cfg, model)
    Generator(cfg, model, device="cpu")


def test_dense_model_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import Transformer, params_from_reference
    from repro_torch.serve import Generator

    full = get_config("llama3.2-3b")
    cfg = reduce_config(full)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer(full).init(seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_reference({"groups": []}, cfg)
    model = Transformer(cfg).init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Generator(cfg, model)
    Generator(cfg, model, device="cpu")


def test_attention_modules_import_neither_jax_nor_reference():
    code = ("import sys; import repro_torch.models.attention, "
            "repro_torch.kernels.flash_attention; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120)
    assert out.returncode == 0, out.stderr


def test_generator_rejects_parameters_elsewhere():
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import Transformer
    from repro_torch.serve import Generator

    cfg = reduce_config(get_config("rwkv6-3b"))
    with pytest.raises(ValueError, match="parameters lie on meta"):
        Generator(cfg, Transformer(cfg), device="cpu")


def test_kernel_ops_reject_other_devices():
    from repro_torch.kernels.cell_mixing import cell_mixing
    from repro_torch.kernels.pair_apply import pair_apply

    x = torch.zeros((2, 3, 1), device="meta")
    i = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    u = torch.zeros((4, 2), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        pair_apply(x, i, i, u, u)
    with pytest.raises(ValueError):
        cell_mixing(torch.zeros((2, 3, 3), device="meta"), x)
    assert pair_apply.launches == 0 and cell_mixing.launches == 0


def test_flash_attention_rejects_other_devices():
    from repro_torch.kernels.flash_attention import flash_attention

    before = flash_attention.launches
    q = torch.zeros((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(torch.zeros((1, 2, 8, 64)), q, q)
    assert flash_attention.launches == before


def test_baseline_and_scenario_modules_import_neither_jax_nor_reference():
    code = ("import sys; import repro_torch.core.baselines, "
            "repro_torch.core.scenarios, repro_torch.core.medium, "
            "repro_torch.core.failures, repro_torch.kernels.sample_chunk; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("entry", ["standard_gossip", "run_scenario_matrix",
                                   "scenario", "priced"])
def test_scenario_and_baseline_entry_points_raise_without_cuda(
        no_cuda, rgg500, x0_500, entry):
    plan = P.build_plan(rgg500)
    calls = {
        "standard_gossip": lambda: P.standard_gossip(rgg500, x0_500),
        "run_scenario_matrix": lambda: P.run_scenario_matrix(
            rgg500, x0_500, plan=plan, fixed_ticks_scale=0.2),
        "scenario": lambda: P.multiscale_gossip(
            rgg500, x0_500, plan=plan, fixed_ticks_scale=0.2,
            failures=P.FailureModel(churn_fraction=0.1)),
        "priced": lambda: P.execute_plan(
            plan, x0_500, fixed_ticks_scale=0.2,
            cost=P.CostModel(retransmit_p=0.9)),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_sample_chunk_scenario_rejects_other_devices():
    from repro_torch.core import CostModel, FailureCtx
    from repro_torch.kernels.sample_chunk import sample_chunk

    before = sample_chunk.launches
    adj = P.dense_to_csr(np.zeros((1, 2, 1), np.int32),
                         np.ones((1, 2), np.int32),
                         np.array([2], np.int32)).to_device("meta")
    done = torch.zeros((1, 1), dtype=torch.bool, device="meta")
    ctx = FailureCtx.from_masks(*[np.zeros((1, 2), bool)] * 4, 0, 0, 0, 0.25,
                                device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sample_chunk(0, 8, P.prng.PRNGKey(0, "meta")[None], adj, None, done,
                     torch.zeros(3, dtype=torch.int32, device="meta"),
                     torch.zeros((1, 1), dtype=torch.int32, device="meta"),
                     failure_ctx=ctx, cost=CostModel(retransmit_p=0.9),
                     retx=torch.zeros((1, 1), dtype=torch.int32,
                                      device="meta"))
    assert sample_chunk.launches == before


def test_training_modules_import_neither_jax_nor_reference():
    code = ("import sys; import repro_torch.optim, repro_torch.data, "
            "repro_torch.train, repro_torch.dist, repro_torch.dist.topology, "
            "repro_torch.models.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120)
    assert out.returncode == 0, out.stderr
    for pkg in ("optim", "data", "train", "dist"):
        assert list((SRC / "repro_torch" / pkg).glob("*.py")), pkg


def _meta_grad(*shape):
    return torch.zeros(shape, device="meta", requires_grad=True)


@pytest.mark.parametrize("op", ["rwkv6", "flash_attention", "cell_mixing",
                                "pair_apply"])
def test_kernel_ops_refuse_autograd_before_launch(op):
    """Off the CPU an op raises under autograd, before any launch, when
    a floating input asks for a gradient (its kernel's result would
    carry none); under no_grad the device check runs as before."""
    from repro_torch.kernels.cell_mixing import cell_mixing
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pair_apply import pair_apply
    from repro_torch.kernels.rwkv6 import rwkv6_wkv

    i = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    u = torch.zeros((4, 2), dtype=torch.bool, device="meta")
    calls = {
        "rwkv6": (rwkv6_wkv, lambda: rwkv6_wkv(
            *[_meta_grad(2, 8, 16) for _ in range(4)], _meta_grad(2, 16))),
        "flash_attention": (flash_attention, lambda: flash_attention(
            *[_meta_grad(1, 2, 8, 64) for _ in range(3)])),
        "cell_mixing": (cell_mixing, lambda: cell_mixing(
            _meta_grad(2, 3, 3), _meta_grad(2, 3, 1))),
        "pair_apply": (pair_apply, lambda: pair_apply(
            _meta_grad(2, 3, 1), i, i, u, u)),
    }
    fn, call = calls[op]
    before = fn.launches
    with pytest.raises(RuntimeError, match="forward only"):
        call()
    with torch.no_grad(), pytest.raises(ValueError):
        call()
    assert fn.launches == before


def test_kernel_ops_keep_autograd_on_cpu():
    """On the CPU the ops run their differentiable plain versions."""
    from repro_torch.kernels.rwkv6 import rwkv6_wkv

    r = torch.randn(2, 5, 16, requires_grad=True)
    y = rwkv6_wkv(r, r.detach(), r.detach(), torch.full((2, 5, 16), 0.9),
                  torch.zeros(2, 16))
    (g,) = torch.autograd.grad(y.sum(), [r])
    assert g.shape == r.shape and torch.isfinite(g).all()


def test_training_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import SyncConfig
    from repro_torch.models import Transformer, state_from_reference
    from repro_torch.optim import sgdm
    from repro_torch.train import (
        Trainer, make_decentralized_step, make_train_step,
        run_train_scenarios,
    )

    cfg = reduce_config(get_config("llama3.2-3b"))
    lr = lambda s: 1e-2  # noqa: E731
    data = SyntheticLM(cfg.vocab_size, 8, 2)
    calls = [
        lambda: make_train_step(cfg, sgdm(), lr),
        lambda: make_decentralized_step(cfg, sgdm(), lr, SyncConfig(), 2),
        lambda: Trainer(lambda s, b: (s, {}), {"step": 0}, data),
        lambda: run_train_scenarios(cfg, sgdm(), lr, SyncConfig(), 2, {},
                                    data),
        lambda: state_from_reference({"params": {}}, cfg),
        lambda: Transformer(cfg).init(seed=0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_serving_fleet_modules_import_neither_jax_nor_reference():
    code = ("import sys; import repro_torch.serve.batching, "
            "repro_torch.serve.kv_pages, repro_torch.serve.router, "
            "repro_torch.serve.control_plane, repro_torch.serve.fleet, "
            "repro_torch.core.plan_cache; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120)
    assert out.returncode == 0, out.stderr


def test_serving_fleet_entry_points_raise_without_cuda(no_cuda, rgg500,
                                                       x0_500):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import Transformer
    from repro_torch.serve import (
        ControlPlane, FleetConfig, ModelBackend, run_fleet,
    )

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ControlPlane(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_fleet(FleetConfig(replicas=8, ticks=4))
    cfg = reduce_config(get_config("llama3.2-3b"))
    model = Transformer(cfg).init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelBackend(cfg, model, num_slots=2, num_pages=4, page_size=4,
                     max_prompt_len=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.execute_plan(P.build_plan(rgg500), x0_500,
                       options=P.ExecOptions(schedule="per_tick"))
    nbr, deg, n_nodes, _ = P.batched_graphs([rgg500])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.gossip_until(x0_500[None], nbr, deg, n_nodes, eps=1e-3,
                       schedule="per_tick")


def test_model_backend_rejects_parameters_elsewhere():
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import Transformer
    from repro_torch.serve import ModelBackend

    cfg = reduce_config(get_config("rwkv6-3b"))
    with pytest.raises(ValueError, match="parameters lie on meta"):
        ModelBackend(cfg, Transformer(cfg), num_slots=2, num_pages=4,
                     page_size=4, max_prompt_len=4, device="cpu")


def test_zoo_block_modules_import_neither_jax_nor_reference():
    code = ("import sys; import repro_torch.models.rglru, "
            "repro_torch.models.moe, repro_torch.models.attention; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "gemma2-27b",
                                  "grok-1-314b"])
def test_zoo_entry_points_raise_without_cuda(no_cuda, arch):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import Transformer, params_from_reference
    from repro_torch.serve import Generator, ModelBackend

    cfg = reduce_config(get_config(arch))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer(get_config(arch)).init(seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_reference({"groups": []}, cfg)
    model = Transformer(cfg).init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Generator(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelBackend(cfg, model, num_slots=2, num_pages=4, page_size=4,
                     max_prompt_len=4)
    Generator(cfg, model, device="cpu")


def test_whisper_entry_points_raise_without_cuda(no_cuda):
    """whisper's model, forward, cache and Generator run on the card
    unless the CPU is asked for, like the other models' entry points."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import (
        Transformer, forward, init_cache, params_from_reference)
    from repro_torch.serve import Generator

    full = get_config("whisper-tiny")
    cfg = reduce_config(full)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer(full).init(seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_reference({"groups": [], "encoder": {}}, cfg)
    model = Transformer(cfg).init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Generator(cfg, model)
    frames = np.zeros((1, cfg.encoder_seq, cfg.d_model), np.float32)
    tokens = np.zeros((1, 3), np.int32)
    logits = forward(model, cfg, {"tokens": tokens, "frames": frames})
    cache = init_cache(model, cfg, 1, 4, frames=frames)
    assert logits.device.type == cache["memory"].device.type == "cpu"
    out = Generator(cfg, model, device="cpu").generate(tokens, 2,
                                                        frames=frames)
    assert out.shape[0] == 1


EXAMPLES = ("quickstart", "serve_fleet", "decentralized_consensus",
            "robust_training", "serve_decode", "train_lm")
ROOT = SRC.parent


def test_dryrun_and_examples_import_neither_jax_nor_reference():
    code = (
        "import importlib.util, sys\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.trace_analysis\n"
        f"for name in {EXAMPLES!r}:\n"
        f"    path = {str(ROOT / 'examples')!r} + f'/torch_{{name}}.py'\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120)
    assert out.returncode == 0, out.stderr


def test_examples_and_chip_smoke_name_no_reference_import():
    paths = [ROOT / "examples" / f"torch_{n}.py" for n in EXAMPLES]
    for path in [*paths, ROOT / "chip_smoke.py"]:
        text = path.read_text()
        for bad in ("import jax", "from jax", "import repro\n", "from repro.",
                    "from repro import", "import repro."):
            assert bad not in text, (path, bad)


@pytest.mark.parametrize(("name", "argv"), [
    ("quickstart", ["--n", "50"]),
    ("serve_fleet", ["--replicas", "2", "--ticks", "4"]),
    ("decentralized_consensus", ["--steps", "1"]),
    ("robust_training", ["--steps", "1"]),
    ("serve_decode", ["--steps", "1"]),
    ("train_lm", ["--steps", "1"]),
])
def test_examples_run_on_the_card_by_default(no_cuda, name, argv, tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if name == "train_lm":
        argv = [*argv, "--ckpt-dir", str(tmp_path)]
    args = mod.parse(argv)
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.run(args)
