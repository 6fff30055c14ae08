"""Compare the SASS of the generation kernels' instances between another
tree's CUDA sources and this one's, on a machine with nvcc and cuobjdump.

    python3 -m nv_wavenet_tpu_torch.tools.sass_compare OTHER_CSRC_DIR

OTHER_CSRC_DIR holds the other tree's `nv_wavenet_tpu_torch/csrc/` (for
example a `git archive` of the parent commit unpacked into a directory that
.gitignore lists).  Those of its generation sources (this tree's
`build.PRECISION_SOURCES`, `staged_stream_generate.cu`, whose staged K4
now lives in `staged_generate.cu`, and `persistent.cu`, whose K2/K3 the
first K4 and the generic kernel took) it has are built as this tree's are
(`utils/build.py`: its flags, one library per precision with
-DNVW_PREC=0, 1, 2), and `cuobjdump -sass` of every instance is compared
with this tree's instance of the same key, in every precision, whichever
source holds it.  An instance is named by its kernel, its template
arguments and its precision: the other tree's K4 may predate the precision
parameter (the exact instance then), its K6 carry it as the old `kFast`
flag, its K2/K3 template a leading kRagged flag (false for them), its
staged K1/K5 no geometry (the generic one); an injected-selector instance
of `persistent_generate_kernel` (the K1/K5 of commit 14b57bc) is keyed as
the generic K1/K5 of `generic_generate.cu`, so a tree of that time holds
the restored kernel against its original; the generic kernel's own K2/K3
(kSel 1 and 2) are keyed apart from `persistent_generate_kernel`'s, which
have no counterpart here.  The first K6 keeps its kernel's
name in `fused_chain_first.cu`, so it is held against an older tree's
`fused_chain.cu`; the first K4's general instances (a fourth template
argument, true) are keyed apart from its others, which keep their old
keys; the cluster K6 (`cluster_chain_kernel`) is new.  The staged step's
one template, `staged_generate_kernel<kRagged, kModes, kStorage, kPrec,
kGeo>`, is keyed as the two kernels it replaced: its K1/K5 instances (kModes
2) as the former `staged_generate_kernel<kRagged, kPrec, kGeo>`, its
all-mode instances (kModes 4: K2, K3, K4) as `staged_stream_kernel<kStorage,
kPrec, kGeo>`.
Instruction text is compared with the addresses and encodings stripped, so
identical code at identical offsets is "identical"; an instance that
differs is also compared with the kernel parameters' offsets in the
constant bank (`c[0x0][...]`, also where a register indexes them) masked,
and listed under "differ_in_param_offsets_only" when that alone tells them
apart.  Prints
one line per instance found in both trees and a JSON summary as its last
line, which also lists the instances found only here ("only_here") and
only in the other tree ("only_there"); exits 0 whatever it finds.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

from nv_wavenet_tpu_torch.utils import build

SOURCES = build.PRECISION_SOURCES
# sources an older tree may have, whose instances this tree keeps elsewhere
RETIRED_SOURCES = ("staged_stream_generate.cu", "persistent.cu")
_KERNEL = re.compile(r"(persistent_generate_kernel|staged_generate_kernel|"
                     r"generic_generate_kernel|staged_stream_kernel|"
                     r"stream_generate_kernel|fused_generate_kernel|"
                     r"cluster_chain_kernel)"
                     r"I((?:L[bi]n?\d+E)+)E")
_ARG = re.compile(r"L[bi](n?\d+)E")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
# a kernel parameter: c[0x0][offset], or c[0x0][R+offset] where a register
# indexes an array of the parameters
_PARAM = re.compile(r"c\[0x0\]\[(?:R\d+\+)?0x[0-9a-f]+\]")


def instance_key(mangled: str):
    """(kernel, other template arguments, precision) of a mangled kernel
    name, or None.  K2/K3's template is <kSel, kPrec>, once <kRagged, kSel,
    kPrec>: the key keeps a kRagged of 0 for the newer form.  K4's is
    <kStorage, kSel, kPrec>, once without kPrec (exact).  K6's last
    argument is its precision (once the kFast flag: false exact, true
    fast).  The staged K1/K5's is <kRagged, kPrec, kGeo>, once without kGeo
    (the generic instance, 0).  The generic kernel's is <kRagged, kSel,
    kPrec>, once <kRagged, kPrec> (K1/K5 only) and before that <kRagged,
    kSelInjected, kPrec> of persistent_generate_kernel (the K1/K5 of commit
    14b57bc): its K1/K5 keep the key (kRagged,), its K2/K3 (0, kSel).
    The staged K4's is <kStorage, kPrec, kGeo>; the one staged template's
    <kRagged, kModes, kStorage, kPrec, kGeo> is keyed as the staged K1/K5
    (kModes 2) or the staged K4 (kModes 4)."""
    m = _KERNEL.search(mangled)
    if not m:
        return None
    kernel = m.group(1)
    args = [int(a.replace("n", "-")) for a in _ARG.findall(m.group(2))]
    if kernel == "persistent_generate_kernel":
        if len(args) == 2:
            args = [0] + args
        if args[1] == 0:   # kSelInjected: the former K1/K5
            return "generic_generate_kernel", (args[0],), args[2]
        return kernel, tuple(args[:-1]), args[-1]
    if kernel == "generic_generate_kernel":
        if len(args) == 3 and args[1]:   # K2/K3
            return kernel, (args[0], args[1]), args[2]
        return kernel, (args[0],), args[-1]
    if kernel == "staged_stream_kernel":
        return kernel, (args[0], args[2]), args[1]
    if kernel == "stream_generate_kernel" and len(args) == 4:
        # <kStorage, kSel, kPrec, kGeneral>: the general instances apart
        return kernel, tuple(args[:2]) + ((1,) if args[3] else ()), args[2]
    if kernel == "staged_generate_kernel" and len(args) == 5:
        ragged, modes, storage, prec, geo = args
        if modes == 4:
            return "staged_stream_kernel", (storage, geo), prec
        return kernel, (ragged, geo), prec
    if kernel == "staged_generate_kernel":
        return kernel, (args[0], args[2] if len(args) == 3 else 0), args[1]
    if kernel in ("fused_generate_kernel", "cluster_chain_kernel") or len(
            args) == 3:
        return kernel, tuple(args[:-1]), args[-1]
    return kernel, tuple(args), 0


def sass_functions(cuobjdump: str, lib: str) -> dict:
    """{instance key: [instruction text]} of a shared library."""
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, key = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            key = instance_key(line.split("Function :", 1)[1].strip())
            if key is not None:
                funcs[key] = []
            continue
        m = _INSN.search(line)
        if key is not None and m:
            funcs[key].append(m.group(1))
    return funcs


def build_other(csrc: str, out_dir: str) -> dict:
    """Build the other tree's sources in parallel, one library per
    precision as `utils/build.py` does: {source: [libraries]}."""
    nvcc = build.find_nvcc()
    procs = []
    for src in SOURCES + RETIRED_SOURCES:
        if not os.path.exists(os.path.join(csrc, src)):
            continue   # a source the other tree does not have
        for prec, pid in build.PREC_IDS.items():
            lib = os.path.join(out_dir, f"lib{os.path.splitext(src)[0]}_{prec}.so")
            procs.append((src, lib, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, f"-DNVW_PREC={pid}", "-o", lib,
                 os.path.join(csrc, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for src, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {csrc}/{src}:\n{log}")
        libs.setdefault(src, []).append(lib)
    return libs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not os.path.isdir(argv[0]):
        print(__doc__, file=sys.stderr)
        return 2
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        other = build_other(os.path.abspath(argv[0]), tmp)
        build.build_all()
        summary = {"compared": 0, "identical": 0, "differ": [],
                   "differ_in_param_offsets_only": [], "only_here": [],
                   "only_there": []}
        old, new = {}, {}
        for libs in other.values():
            for lib in libs:
                old.update(sass_functions(cuobjdump, lib))
        for u in build.UNITS:
            if u.partition("@")[0] in SOURCES:
                new.update(sass_functions(cuobjdump, build.library_path(u)))
        def name_of(key):
            return f"{key[0]}<{', '.join(map(str, key[1]))}> prec {key[2]}"
        summary["only_there"] = [name_of(k) for k in sorted(old)
                                 if k not in new]
        for key in sorted(new):
            name = name_of(key)
            if key not in old:
                summary["only_here"].append(name)
                continue
            same = old[key] == new[key]
            summary["compared"] += 1
            summary["identical"] += same
            params_only = not same and (
                [_PARAM.sub("c[0x0][*]", i) for i in old[key]]
                == [_PARAM.sub("c[0x0][*]", i) for i in new[key]])
            if not same:
                summary["differ"].append(name)
            if params_only:
                summary["differ_in_param_offsets_only"].append(name)
            print(f"[sass] {name}: {len(old[key])} vs {len(new[key])} "
                  f"instructions, identical {same}"
                  + (", but for the parameters' offsets" if params_only
                     else ""), flush=True)
    print(json.dumps({"sass_compare": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
