"""What the benchmark may import: nothing whose top-level name is jax,
jaxlib, flax or the JAX package ``repro`` (names compared whole, so the
port ``repro_torch`` passes), and in the reference nothing of the port."""
import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in PB.rglob("*.py") if "out" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_or_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & {"repro_torch", "perfbench"}


def test_names_compare_whole():
    from perfbench import run
    assert run.forbidden_loaded(["repro_torch.serve.engine", "reprox",
                                 "perfbench.run", "jaxtyping"]) == []
    assert run.forbidden_loaded(["repro.serve", "jaxlib.xla_client",
                                 "flax", "torch"]) == ["flax", "jaxlib",
                                                       "repro"]
