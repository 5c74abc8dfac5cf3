"""No module of the benchmark imports jax or the JAX package (top-level
names compared whole: stark_tpu_torch is not stark_tpu), and the reference
imports nothing of the measured program."""

from __future__ import annotations

import ast
import sys
import types

from benchmark import harness as H

FORBIDDEN = {"jax", "jaxlib", "flax", "stark_tpu"}


def imported(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and ":" in node.value and "." in node.value.split(":")[0]:
            tops.add(node.value.split(".")[0])  # a "module:function" by name
    return tops


def test_no_jax_anywhere():
    for path in H.HERE.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path
    for path in H.HERE.rglob("*.json"):
        text = path.read_text()
        assert '"stark_tpu.' not in text and '"jax' not in text, path


def test_reference_imports_nothing_of_the_program():
    for path in (H.HERE / "reference").rglob("*.py"):
        assert not imported(path) & (FORBIDDEN | {"stark_tpu_torch"}), path


def test_loaded_names_are_compared_whole(monkeypatch):
    import stark_tpu_torch  # noqa: F401

    assert "stark_tpu" not in H.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert H.forbidden_loaded() == ["jax"]
