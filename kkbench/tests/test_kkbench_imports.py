"""No module of the benchmark imports JAX or ``tpukk``, and the reference
imports nothing of the port either: each import's top-level name (before
the first dot) is compared whole, so ``tpukk_torch`` is not ``tpukk``."""
from __future__ import annotations

import ast

import pytest

from conftest import ROOT

KKB = ROOT / "kkbench"
NEVER = {"jax", "jaxlib", "flax", "tpukk", "chip_smoke"}
FILES = sorted(p for p in KKB.rglob("*.py") if "__pycache__" not in p.parts)


def tops(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(KKB)))
def test_no_jax_or_tpukk(path):
    assert not tops(path) & NEVER


@pytest.mark.parametrize("path", sorted((KKB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "tpukk_torch" not in tops(path)


def test_names_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import tpukk_torch.sparse\nfrom jaxtyping import x\n")
    assert not tops(f) & NEVER
    f.write_text("from tpukk.sparse import pcg\n")
    assert tops(f) & NEVER == {"tpukk"}
