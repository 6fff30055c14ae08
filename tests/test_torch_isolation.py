"""The port stands alone: nothing under nv_wavenet_tpu_torch/, and not
chip_smoke.py, imports jax or the JAX package (`nv_wavenet_tpu`, but not the
port's own `nv_wavenet_tpu_torch`), whether read from the source or observed
in `sys.modules` after importing every module; importing needs no nvcc; and
chip_smoke.py fails, printing no result, where there is no card."""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "nv_wavenet_tpu_torch"
FORBIDDEN = re.compile(r"^(jax|jaxlib|nv_wavenet_tpu)(\.|$)")
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PKG.rglob("*.py"))


def imported_names(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and (getattr(node.func, "id", None) == "__import__"
                   or getattr(node.func, "attr", None) == "import_module")):
            yield node.args[0].value


def test_forbidden_pattern():
    assert FORBIDDEN.match("nv_wavenet_tpu") and FORBIDDEN.match("jax.numpy")
    assert FORBIDDEN.match("nv_wavenet_tpu.ops.exact_math")
    assert not FORBIDDEN.match("nv_wavenet_tpu_torch.ops.exact_math")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    bad = [n for n in imported_names(path) if FORBIDDEN.match(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _env_without_nvcc(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH", "PYTHONPATH")}
    bindir = tmp_path / "bin"
    bindir.mkdir()
    os.symlink(sys.executable, bindir / "python3")
    env["PATH"] = str(bindir)
    return env


def test_import_needs_no_jax_and_no_nvcc(tmp_path):
    """Import every module of the port in a fresh interpreter whose PATH
    holds no nvcc: no jax and no nv_wavenet_tpu module gets loaded, and
    nothing is built."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_env_without_nvcc(tmp_path), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(MODULES) <= set(mods)
    bad = [m for m in mods if FORBIDDEN.match(m)]
    assert not bad, f"importing the port loaded {bad}"


def test_chip_smoke_fails_without_a_card(tmp_path):
    if _cuda_available():
        pytest.skip("a CUDA device is present: run chip_smoke.py itself")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_env_without_nvcc(tmp_path), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _cuda_available() -> bool:
    import torch
    return torch.cuda.is_available()
