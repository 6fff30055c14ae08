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
              persistent.GENERIC_KERNELS, persistent.GENERIC_RAGGED_KERNELS,
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
        build.unit("staged_generate.cu", "fmad")
    assert "#if NVW_FMAD" in (CSRC / "probes.cu").read_text()
    units = {k.source for k in (*probe_exact_math.FMA_PROBE_KERNELS.values(),
                                *probe_stage.STAGE_CHAIN_KERNELS.values())}
    assert units == {"probes.cu", "probes.cu@fmad"}


@pytest.mark.parametrize("mangled,key", [
    # the staged step's one template <kRagged, kModes, kStorage, kPrec, kGeo>
    ("_ZN12_GLOBAL__N_122staged_generate_kernelILb0ELi2ELi0ELi0ELi1EEEvN"
     "10StagedArgsE", ("staged_generate_kernel", (0, 1), 0)),
    ("_ZN12_GLOBAL__N_122staged_generate_kernelILb1ELi2ELi1ELi2ELi0EEEvN"
     "10RaggedArgsE", ("staged_generate_kernel", (1, 0), 2)),
    ("_ZN12_GLOBAL__N_122staged_generate_kernelILb0ELi4ELi2ELi1ELi2EEEvN"
     "10StreamArgsE", ("staged_stream_kernel", (2, 2), 1)),
    # the two kernels it replaced, as an older tree names them
    ("_ZN12_GLOBAL__N_122staged_generate_kernelILb0ELi0ELi1EEEvN"
     "10StagedArgsE", ("staged_generate_kernel", (0, 1), 0)),
    ("_ZN12_GLOBAL__N_120staged_stream_kernelILi2ELi1ELi2EEEvN10StreamArgsE",
     ("staged_stream_kernel", (2, 2), 1)),
    # the generic kernel <kRagged, kSel, kPrec>: K1/K5 as the older
    # <kRagged, kPrec>, its K2/K3 apart from persistent.cu's
    ("_ZN12_GLOBAL__N_123generic_generate_kernelILb1ELi0ELi2EEEvN"
     "13GenRaggedArgsE", ("generic_generate_kernel", (1,), 2)),
    ("_ZN12_GLOBAL__N_123generic_generate_kernelILb1ELi2EEEvN13GenRaggedArgsE",
     ("generic_generate_kernel", (1,), 2)),
    ("_ZN12_GLOBAL__N_123generic_generate_kernelILb0ELi1ELi0EEEvN"
     "12GenScoreArgsE", ("generic_generate_kernel", (0, 1), 0)),
    ("_ZN12_GLOBAL__N_126persistent_generate_kernelILi2ELi1EEEvN7GenArgsE",
     ("persistent_generate_kernel", (0, 2), 1)),
])
def test_sass_compare_keys_the_staged_template_as_the_kernels_it_replaced(
        mangled, key):
    """tools/sass_compare.py holds each instance of the one staged template
    against the instance of the kernel it replaced: K1/K5's (kModes 2) as
    the former staged_generate_kernel<kRagged, kPrec, kGeo>, the all-mode
    ones (K2, K3, K4) as the former staged_stream_kernel<kStorage, kPrec,
    kGeo>; the generic K1/K5 as before their kSel, and the generic K2/K3
    apart from persistent.cu's former K2/K3."""
    from nv_wavenet_tpu_torch.tools import sass_compare
    assert sass_compare.instance_key(mangled) == key
