"""The kernels' build (`nv_wavenet_tpu_torch/utils/build.py`), checked on
the CPU without nvcc: every CUDA source is built, every header it includes
lies in csrc/, and the build directory changes with any file of csrc/, so
an edit to a header shared by several sources rebuilds each of them."""

import pathlib
import re
import shutil

import pytest

from nv_wavenet_tpu_torch.utils import build

CSRC = pathlib.Path(build.CSRC_DIR)
FILES = sorted(p.name for p in CSRC.iterdir()
               if p.suffix in (".cu", ".cuh"))


def test_every_cuda_source_is_built():
    assert sorted(build.SOURCES) == sorted(
        f for f in FILES if f.endswith(".cu"))


@pytest.mark.parametrize("name", FILES)
def test_local_includes_lie_in_csrc(name):
    text = (CSRC / name).read_text()
    for inc in re.findall(r'^#include "([^"]+)"', text, re.M):
        assert (CSRC / inc).is_file(), f"{name} includes missing {inc}"


@pytest.mark.parametrize("name", FILES)
def test_build_dir_keys_on_every_csrc_file(name, tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy)
    monkeypatch.setattr(build, "CSRC_DIR", str(copy))
    before = build.build_dir()
    with open(copy / name, "a") as f:
        f.write("\n// edited\n")
    assert build.build_dir() != before
    assert all(build.library_path(s).startswith(build.build_dir())
               for s in build.SOURCES)


def test_every_kernel_is_in_a_unit_of_its_precision():
    """Each source with a precision is built once per precision into its
    own library, guarded by NVW_PREC; every kernel wrapper names one of the
    units, and the precisions are scan_generate's."""
    from nv_wavenet_tpu_torch.ops import fused_chain, persistent, scan_generate
    assert tuple(build.PREC_IDS) == scan_generate.PRECISIONS
    assert len({build.library_path(u) for u in build.UNITS}) == len(build.UNITS)
    for src in build.PRECISION_SOURCES:
        text = (CSRC / src).read_text()
        for n in build.PREC_IDS.values():
            assert f"NVW_PREC == {n}" in text, (src, n)
    tables = (persistent.PERSISTENT_KERNELS, persistent.RAGGED_KERNELS,
              persistent.FORCED_KERNELS, persistent.PRNG_KERNELS,
              persistent.STREAM_KERNELS)
    for table in tables:
        for prec, kernel in table.items():
            assert kernel.source == build.unit(kernel.source.split("@")[0],
                                               prec) in build.UNITS
    for (_, prec), kernel in fused_chain.FUSED_KERNELS.items():
        assert kernel.source == build.unit("fused_chain.cu", prec)
    for (_, prec), kernel in fused_chain.FIRST_FUSED_KERNELS.items():
        assert kernel.source == build.unit("fused_chain_first.cu", prec)
    with pytest.raises(ValueError, match="precision"):
        build.unit("ordered_matmul.cu", "bf16")


def test_the_probe_alone_is_also_built_with_contraction(tmp_path,
                                                        monkeypatch):
    """csrc/probes.cu is built twice: unit probes.cu with the port's
    -fmad=false, unit probes.cu@fmad with -fmad=true and NVW_FMAD=1 (P1
    shows the contraction there); every other library keeps -fmad=false,
    and each probe wrapper names its unit.  The nvcc commands are recorded
    by a stand-in for the compiler."""
    from nv_wavenet_tpu_torch.tools import probe_exact_math, probe_stage
    cmds = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, stdout, stderr):
            cmds.append(cmd)
            open(cmd[cmd.index("-o") + 1], "w").close()

        def poll(self):
            return 0

    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    build.build_all()
    assert len(cmds) == len(build.UNITS)
    for cmd in cmds:
        fmad = "libprobes_fmad.so" in cmd[cmd.index("-o") + 1]
        assert ("-fmad=true" in cmd) == ("-DNVW_FMAD=1" in cmd) == fmad
        assert ("-fmad=false" in cmd) != fmad
    assert sum("-fmad=true" in c for c in cmds) == 1
    with pytest.raises(ValueError, match="precision"):
        build.unit("persistent.cu", "fmad")
    assert "#if NVW_FMAD" in (CSRC / "probes.cu").read_text()
    units = {k.source for k in (*probe_exact_math.FMA_PROBE_KERNELS.values(),
                                *probe_stage.STAGE_CHAIN_KERNELS.values())}
    assert units == {"probes.cu", "probes.cu@fmad"}
