"""The port's six example scripts (`examples/torch_*.py`) against the
reference's (`examples/*.py`) on the CPU, at small sizes.

Each reference script's `main` runs with a patched ``sys.argv`` inside
`jax.threefry_partitionable(False)` (the port's one threefry layout) and
its printed lines are read; the port's `run` takes the same arguments
plus ``--device cpu`` and returns its figures.

* quickstart: the graph's edges, the levels and the longest route are
  equal; the messages are held as `test_torch_engine.py`'s
  `test_eps_mode_allclose` holds them (within 5% of the reference's),
  path averaging's (host numpy in both) equal.
* serve_fleet: every printed line is equal (`test_torch_serve.py` holds
  every field of each router's `run_fleet` result equal).
* decentralized_consensus, robust_training and train_lm, given the
  reference script's own parameters (`params_from_reference`): each
  printed loss and consensus figure is held at
  `test_torch_decentralized.py`'s and `test_torch_train.py`'s
  tolerances (1e-5 for sgdm, 1e-4 for a loss trajectory through top-k
  or AdamW), beyond the rounding of the printed digits; train_lm's
  losses are read at full precision from both runs' metrics files, and a
  second run resumes at the saved step.
* serve_decode: both scripts' generators made greedy and their reduced
  config f32, the tokens are equal, as `test_torch_models.py` holds
  greedy tokens.
"""
import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.models import params_from_reference  # noqa: E402
from repro_torch.serve import ROUTERS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The scripts' small CPU ops on one thread: more spin against each
    other, and against other processes, many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(name, argv, capsys, monkeypatch, **patch):
    """The reference script's printed lines for `argv`."""
    mod = _load(name)
    for attr, value in patch.items():
        monkeypatch.setattr(mod, attr, value(getattr(mod, attr)))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    with jax.threefry_partitionable(False):
        mod.main()
    return capsys.readouterr().out


def _port(name, argv, capsys, params=None, **patch):
    mod = _load(f"torch_{name}")
    for attr, value in patch.items():
        setattr(mod, attr, value(getattr(mod, attr)))
    capsys.readouterr()
    out = mod.run(mod.parse([*argv, "--device", "cpu"]), params=params)
    return out, capsys.readouterr().out, mod


def _reference_init(RM, rcfg):
    """The reference scripts' parameters: seed 0, drawn in the threefry
    layout their `main` runs under here."""
    with jax.threefry_partitionable(False):
        return RM.Transformer(rcfg, model_axis=1).init(jax.random.PRNGKey(0))


def _num(pattern: str, text: str) -> list:
    return [m.replace(",", "") for m in re.findall(pattern, text)]


def _close_to_printed(value: float, printed: str, rtol: float) -> bool:
    """`value` agrees with the printed figure within `rtol` beyond the
    rounding of its last printed digit."""
    mant = printed.lower().split("e")[0]
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    exp = int(printed.lower().split("e")[1]) if "e" in printed.lower() else 0
    half = 0.5 * 10.0 ** (exp - decimals)
    return abs(value - float(printed)) <= half + rtol * abs(float(printed))


# ------------------------------ quickstart -----------------------------


def test_quickstart(capsys, monkeypatch):
    argv = ["--n", "300"]
    want = _reference("quickstart", argv, capsys, monkeypatch)
    got, text, _ = _port("quickstart", argv, capsys)
    assert _num(r"edges=(\d+)", text) == _num(r"edges=(\d+)", want)
    assert int(_num(r"edges=(\d+)", want)[0]) == got["edges"]
    assert _num(r"sides=(\(.*?\))", text) == _num(r"sides=(\(.*?\))", want)
    assert _num(r"longest route\s+= (\d+)", want) == [
        str(got["longest_route"])]
    ms, pa, sg = (int(v) for v in _num(r"messages\s+= ([\d,]+)", want))
    assert abs(got["messages"] - ms) <= 0.05 * ms
    assert got["pa_messages"] == pa
    assert abs(got["sg_messages"] - sg) <= 0.05 * sg
    assert got["error"] <= 1e-4 and got["error"] <= got["bound"]


# ------------------------------ serve_fleet ----------------------------


def test_serve_fleet(capsys, monkeypatch):
    argv = ["--replicas", "16", "--ticks", "60"]
    want = _reference("serve_fleet", argv, capsys, monkeypatch)
    got, text, _ = _port("serve_fleet", argv, capsys)
    assert text == want
    assert set(got["results"]) == set(ROUTERS)
    assert got["ratio"] == (got["results"]["p2c_gossip"].throughput
                            / got["results"]["oracle"].throughput)


# -------------------- decentralized and robust training ----------------


def _demo_params(mod):
    """The reference script's parameters (its seed 0) in the port."""
    import repro.models as RM
    from repro.models.config import ModelConfig as RefConfig

    fields = {f.name: getattr(mod.CFG, f.name)
              for f in dataclasses.fields(mod.CFG)}
    rcfg = RefConfig(**fields)
    ref = _reference_init(RM, rcfg)
    return params_from_reference(jax.tree.map(np.asarray, ref), mod.CFG,
                                 device="cpu")


def _check_steps(history, text, keys, rtol):
    rows = re.findall(r"step\s+(\d+)\s+(.*)", text)
    assert rows
    for step, rest in rows:
        printed = dict(re.findall(r"(\w+)=([-\d.e+]+)", rest))
        for name, key in keys.items():
            assert _close_to_printed(history[int(step)][key], printed[name],
                                     rtol), (step, name)


CONSENSUS = {
    # top-k is discontinuous: its loss trajectory is held over 3 steps,
    # as `test_torch_decentralized.py` holds it
    "multiscale topk rotate": (["--strategy", "multiscale", "--compress",
                                "topk", "--rotate", "4", "--replicas", "8",
                                "--steps", "3"], 1e-4),
    "multiscale overlap": (["--strategy", "multiscale", "--overlap",
                            "--replicas", "8", "--steps", "6"], 1e-5),
    "allreduce": (["--strategy", "allreduce", "--replicas", "4",
                   "--steps", "6"], 1e-5),
}


@pytest.mark.parametrize("case", list(CONSENSUS))
def test_decentralized_consensus(case, capsys, monkeypatch):
    argv, rtol = CONSENSUS[case]
    mod = _load("torch_decentralized_consensus")
    params = _demo_params(mod)
    want = _reference("decentralized_consensus", argv, capsys, monkeypatch)
    got, text, _ = _port("decentralized_consensus", argv, capsys, params)
    assert text.splitlines()[0] == want.splitlines()[0]
    assert text.splitlines()[-1] == want.splitlines()[-1]
    _check_steps(got["history"], want, {"loss": "loss",
                                        "consensus": "consensus_distance",
                                        "overlap": "sync_overlap_fraction"},
                 rtol)


def test_robust_training(capsys, monkeypatch):
    # uncompressed, so the whole 8-step trajectory (which the script's
    # own last-5-below-first-5 check needs) is held at sgdm's 1e-5
    argv = ["--replicas", "8", "--steps", "8", "--churn", "0.25",
            "--byzantine", "0.125", "--aggregation", "trimmed_mean"]
    mod = _load("torch_robust_training")
    params = _demo_params(mod)
    want = _reference("robust_training", argv, capsys, monkeypatch)
    got, text, _ = _port("robust_training", argv, capsys, params)
    assert text.splitlines()[0] == want.splitlines()[0]
    assert text.splitlines()[-1] == want.splitlines()[-1]
    _check_steps(got["history"], want,
                 {"loss": "loss", "survivor_err": "survivor_consensus_error",
                  "eff_frac": "effective_replica_fraction",
                  "rejected": "rejected_gradient_count"}, 1e-5)


# ------------------------------- train_lm ------------------------------


def _losses(path: Path) -> dict:
    return {r["step"]: r["loss"] for r in map(json.loads,
                                             path.read_text().splitlines())}


def test_train_lm_and_resume(capsys, monkeypatch, tmp_path):
    import repro.models as RM
    from repro.models.config import ModelConfig as RefConfig

    mod = _load("torch_train_lm")
    cfg = mod.preset_config("smoke")
    rcfg = RefConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)})
    ref = _reference_init(RM, rcfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                   device="cpu")
    steps = ["--preset", "smoke", "--steps", "6"]
    _reference("train_lm", [*steps, "--ckpt-dir", str(tmp_path / "ref")],
               capsys, monkeypatch)
    got, text, _ = _port("train_lm", [*steps, "--ckpt-dir",
                                      str(tmp_path / "port")], capsys, params)
    want = _losses(tmp_path / "ref" / "metrics.jsonl")
    assert got["start_step"] == 0 and len(want) == 6
    for rec in got["history"]:
        np.testing.assert_allclose(rec["loss"], want[rec["step"]], rtol=1e-4)
    assert "loss should decrease" not in text
    # a second run resumes at the saved step and goes on
    again, text, _ = _port("train_lm", ["--preset", "smoke", "--steps", "16",
                                        "--ckpt-dir", str(tmp_path / "port")],
                           capsys)
    assert again["start_step"] == 6
    assert [r["step"] for r in again["history"]] == list(range(7, 17))
    assert "resumed from step 6" in text


def test_train_lm_checkpoints_stay_off_the_reference_path():
    mod = _load("torch_train_lm")
    ckpt = mod.parse([]).ckpt_dir
    assert ckpt != "/tmp/repro_train_lm"
    assert Path(ckpt).name == "repro_torch_train_lm"


# ----------------------------- serve_decode ----------------------------


def _f32(fn):
    return lambda cfg: dataclasses.replace(fn(cfg), dtype="float32")


def _greedy(cls):
    def make(*args, **kwargs):
        return cls(*args, **{**kwargs, "temperature": 0.0})
    return make


@pytest.mark.parametrize("arch", ("llama3.2-3b", "rwkv6-3b"))
def test_serve_decode_greedy(arch, capsys, monkeypatch):
    import repro.configs as RC
    import repro.models as RM

    argv = ["--arch", arch, "--batch", "2", "--steps", "6"]
    want = _reference("serve_decode", argv, capsys, monkeypatch,
                      reduce_config=_f32, Generator=_greedy)
    rcfg = dataclasses.replace(RC.reduce_config(RC.get_config(arch)),
                               dtype="float32")
    ref = _reference_init(RM, rcfg)
    mod = _load("torch_serve_decode")
    cfg = _f32(mod.reduce_config)(mod.get_config(arch))
    params = params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                   device="cpu")
    got, text, _ = _port("serve_decode", argv, capsys, params,
                         reduce_config=_f32, Generator=_greedy)
    assert text.splitlines()[0] == want.splitlines()[0]
    ids = re.search(r"sample token ids: (\[.*\])", want).group(1)
    assert got["tokens"][0][:16].tolist() == json.loads(ids)
    assert got["tokens"].shape == (2, 6)
    live = re.search(r"(\d+)/(\d+) live\)", want).groups()
    assert (got["stats"]["live_tokens"], got["tokens"].size) == tuple(
        map(int, live))
