"""The port's import layering, read from the sources with ``ast`` (imports
inside functions included): the ops under ``ops/`` import nothing from the
layers above them, and joint BA takes the registrator's H,b math from
``ops/``, never from the optimizer."""

import ast
from pathlib import Path

import pytest

PKG = "dataset_pipeline_tpu_torch"
ROOT = Path(__file__).resolve().parents[1] / PKG


def _imported_modules(path: Path):
    """Every module that ``path`` imports, as dotted absolute names; for
    ``from a import b`` both ``a`` and ``a.b`` (``b`` may be a module)."""
    package = ".".join((PKG,) + path.relative_to(ROOT).parent.parts)
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = package.split(".")[:len(package.split(".")) - node.level + 1]
                base = ".".join(parent + ([base] if base else []))
            out.add(base)
            out.update(f"{base}.{a.name}" for a in node.names)
    return out


def _under(module: str, prefix: str) -> bool:
    return module == prefix or module.startswith(prefix + ".")


def test_the_ops_import_nothing_from_the_layers_above():
    above = [f"{PKG}.{layer}" for layer in ("photometric", "parallel", "tools")]
    paths = sorted((ROOT / "ops").glob("*.py"))
    assert paths
    bad = {p.name: sorted(m for m in _imported_modules(p) if any(_under(m, a) for a in above))
           for p in paths}
    assert {k: v for k, v in bad.items() if v} == {}


@pytest.mark.parametrize("name", ["ba", "joint_ba", "joint_ba_rig"])
def test_joint_ba_imports_nothing_from_the_optimizer(name):
    mods = _imported_modules(ROOT / "parallel" / f"{name}.py")
    assert not [m for m in mods if _under(m, f"{PKG}.photometric.optimizer")]
    assert f"{PKG}.ops.hb_geometry" in mods
