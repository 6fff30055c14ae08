"""The port stands alone: nothing under nv_wavenet_tpu_torch/, and not
chip_smoke.py, imports jax (nor flax, optax or orbax) or the JAX package
(`nv_wavenet_tpu`, but not the port's own `nv_wavenet_tpu_torch`), whether
read from the source or observed in `sys.modules` after importing every
module; importing needs no nvcc; and chip_smoke.py fails, printing no
result, where there is no card."""

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
FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|optax|orbax|nv_wavenet_tpu)(\.|$)")
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


# the modules of the speculative slice, with its probes and cost model
SLICE_MODULES = ("nv_wavenet_tpu_torch.ops.speculative",
                 "nv_wavenet_tpu_torch.utils.profiling",
                 "nv_wavenet_tpu_torch.tools.probe_exact_math",
                 "nv_wavenet_tpu_torch.tools.probe_stage",
                 "nv_wavenet_tpu_torch.tools.perf")


# the modules of the training slice
TRAIN_MODULES = ("nv_wavenet_tpu_torch.utils.mu_law",
                 "nv_wavenet_tpu_torch.train.data",
                 "nv_wavenet_tpu_torch.train.trainer",
                 "nv_wavenet_tpu_torch.train.cli",
                 "nv_wavenet_tpu_torch.models.wavenet",
                 "nv_wavenet_tpu_torch.parallel.mesh",
                 "nv_wavenet_tpu_torch.tools.mel2samp",
                 "nv_wavenet_tpu_torch.tools.inference")


# the modules of the mesh and tools slice
MESH_MODULES = ("nv_wavenet_tpu_torch.parallel.mesh",
                "nv_wavenet_tpu_torch.engine.nv_wavenet",
                "nv_wavenet_tpu_torch.engine.torch_import",
                "nv_wavenet_tpu_torch.tools.verify_drive",
                "nv_wavenet_tpu_torch.tools.eval_checkpoint",
                "nv_wavenet_tpu_torch.tools.mesh_probe",
                "nv_wavenet_tpu_torch.tools.train_mesh_probe")


def _checked(modules) -> bool:
    names = {p.relative_to(REPO).with_suffix("").as_posix().replace("/", ".")
             for p in SOURCES}
    return set(modules) <= set(MODULES) and set(modules) <= names


def test_the_slice_modules_are_checked():
    """The checks below read and import the speculative slice's modules."""
    assert _checked(SLICE_MODULES)


def test_the_training_modules_are_checked():
    """The checks below read and import the training slice's modules."""
    assert _checked(TRAIN_MODULES)


def test_the_mesh_and_tool_modules_are_checked():
    """The checks below read and import the mesh and tools slice's
    modules."""
    assert _checked(MESH_MODULES)


@pytest.mark.parametrize("module", MESH_MODULES[3:])
def test_user_tools_fail_without_a_card(module, tmp_path):
    """nvw-torch-verify, nvw-torch-eval-checkpoint and the two mesh probes
    run on the card: with none (and no nvcc) they exit non-zero and report
    nothing, unless asked for the CPU."""
    if _cuda_available():
        pytest.skip("a CUDA device is present: run the tools themselves")
    argv = ["-c", str(tmp_path)] if module.endswith("checkpoint") else []
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                         env=_env_without_nvcc(tmp_path), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA device" in out.stderr
    assert ("PASSED" not in out.stdout and "bits/sample" not in out.stdout
            and "mesh_probe" not in out.stdout)


def test_mesh_and_wrappers_need_a_card_unless_asked():
    """data_mesh(), NVWaveNet and torch_import default to the card and
    raise without one; the CPU only when asked."""
    if _cuda_available():
        pytest.skip("a CUDA device is present")
    import torch
    from nv_wavenet_tpu_torch.engine import torch_import
    from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
    from nv_wavenet_tpu_torch.parallel import mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.data_mesh()
    cpu = mesh.data_mesh(2, [torch.device("cpu")] * 2)
    assert WaveNetInfer(2, 2, R=8, S=8, A=8, max_batch=2,
                        mesh=cpu).device.type == "cpu"
    sd = {"embed.weight": torch.zeros(8, 4)}
    with pytest.raises(RuntimeError, match="CUDA device"):
        torch_import.cond_input_from_state_dict(sd, torch.zeros(1, 2, 3), 2)


@pytest.mark.parametrize("module", SLICE_MODULES[2:])
def test_measuring_tools_fail_without_a_card(module, tmp_path):
    """The probes and perf.py measure the card: with none (and no nvcc)
    they exit non-zero and print no rate."""
    if _cuda_available():
        pytest.skip("a CUDA device is present: run the tools themselves")
    out = subprocess.run([sys.executable, "-m", module, "-t", "1"]
                         if module.endswith("perf") else
                         [sys.executable, "-m", module], cwd=REPO,
                         env=_env_without_nvcc(tmp_path), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "Sample rate" not in out.stdout and "ns/stage" not in out.stdout


def test_forbidden_pattern():
    assert FORBIDDEN.match("nv_wavenet_tpu") and FORBIDDEN.match("jax.numpy")
    assert FORBIDDEN.match("nv_wavenet_tpu.ops.exact_math")
    assert not FORBIDDEN.match("nv_wavenet_tpu_torch.ops.exact_math")
    assert all(FORBIDDEN.match(m) for m in ("flax.linen", "optax",
                                            "orbax.checkpoint"))


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
