"""No module of the benchmark imports JAX, the JAX package or its
benchmark drivers, and the reference imports nothing of the port; the
top-level name of each import (before the first dot) is compared
whole, so the port's ``repro_torch`` is not taken for ``repro``."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def imported(path: Path) -> set:
    """Top-level names of every absolute import in `path`; a relative
    import is named by where it leads, relative to the benchmark."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                rel = path.parent
                for _ in range(node.level - 1):
                    rel = rel.parent
                base = rel.relative_to(BENCH.parent).parts
                mod = (node.module or "").split(".")
                out.add(".".join(p for p in (*base, *mod) if p))
            else:
                out.add(node.module.split(".")[0])
    return out


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    for m in imported(path):
        assert m.split(".")[0] != "repro_torch"
        if m.startswith("gossipbench"):
            assert m.startswith("gossipbench.reference"), m


def test_the_names_are_compared_whole(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import repro_torch.core\nfrom repro.core import a\n"
                 "import jaxlib\n")
    tops = {m.split(".")[0] for m in imported(f)}
    assert tops & FORBIDDEN == {"repro", "jaxlib"}
