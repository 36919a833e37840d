"""The port stands alone: importing every module of reviews4rec_torch
loads neither JAX nor the JAX package, and no source of the port (nor
chip_smoke.py, which runs where there is no JAX) imports them."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "reviews4rec_tpu")
SOURCES = sorted((ROOT / "reviews4rec_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_import_loads_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import reviews4rec_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "reviews4rec_torch.serve" in mods
    assert "reviews4rec_torch.train.loop" in mods
    bad = [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"
