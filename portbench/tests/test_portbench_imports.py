"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: minivectordb_tpu_torch begins with minivectordb_tpu."""

import ast
import os

import pytest

from portbench.harness import FORBIDDEN_MODULES

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = set(FORBIDDEN_MODULES)


def imported(path: str) -> set:
    """Top-level names of every module ``path`` imports, at any depth of
    its code."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


def sources():
    for base, _dirs, names in os.walk(PORTBENCH):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(base, n)


def test_the_check_compares_whole_names():
    assert "minivectordb_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "minivectordb_tpu.models".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, PORTBENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


def families():
    """Every module under portbench/families/, as a dotted name under
    portbench."""
    base = os.path.join(PORTBENCH, "families")
    return sorted("families" + ("" if n == "__init__.py" else "." + n[:-3])
                  for n in os.listdir(base) if n.endswith(".py"))


def module_path(name: str) -> str:
    """The file of ``portbench.<name>``, a module or a package."""
    path = os.path.join(PORTBENCH, *name.split("."))
    return path + ".py" if os.path.exists(path + ".py") else os.path.join(path, "__init__.py")


def test_the_reference_imports_nothing_of_the_program():
    """The reference, the frozen tokenizer, the generator of the inputs and
    weights both sides get, the yardstick and every model family; and every
    portbench module they import, transitively."""
    seen, todo = set(), ["reference", "hashtok", "traffic", "counts"] + families()
    assert "families.xlm_roberta" in todo
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        path = module_path(name)
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
            for m in mods:
                assert m.split(".")[0] not in {"minivectordb_tpu_torch"} | FORBIDDEN, (name, m)
                if m.startswith("portbench.") and os.path.exists(module_path(m.split(".", 1)[1])):
                    todo.append(m.split(".", 1)[1])
