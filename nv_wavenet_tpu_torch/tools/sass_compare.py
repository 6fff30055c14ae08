"""Compare the SASS of the generation kernels' instances between another
tree's CUDA sources and this one's, on a machine with nvcc and cuobjdump.

    python3 -m nv_wavenet_tpu_torch.tools.sass_compare OTHER_CSRC_DIR

OTHER_CSRC_DIR holds the other tree's `nv_wavenet_tpu_torch/csrc/` (for
example a `git archive` of the parent commit unpacked into a directory that
.gitignore lists).  Its `persistent.cu`, `stream_generate.cu` and
`fused_chain.cu` are built with this tree's flags (`utils/build.py`), this
tree's libraries as the package builds them (every precision's library of
a source together), and `cuobjdump -sass` of each pair is compared kernel
instance by kernel instance.  An instance is named
by its kernel, its template arguments and its precision: the other tree
may predate the precision parameter (the exact instance then), or carry it
as K6's old `kFast` flag.  Instruction text is compared with the addresses
and encodings stripped, so identical code at identical offsets is
"identical".  Prints one line per instance found in both trees and a JSON
summary as its last line; exits 0 whatever it finds.
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
_KERNEL = re.compile(r"(persistent_generate_kernel|stream_generate_kernel|"
                     r"fused_generate_kernel)I((?:L[bi]\d+E)+)E")
_ARG = re.compile(r"L[bi](\d+)E")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def instance_key(mangled: str):
    """(kernel, leading template arguments, precision) of a mangled kernel
    name, or None.  K1's and K4's instances gained a trailing precision
    argument (exact when absent); K6's last argument is its precision (or
    the older kFast flag: false exact, true fast)."""
    m = _KERNEL.search(mangled)
    if not m:
        return None
    args = [int(a) for a in _ARG.findall(m.group(2))]
    if m.group(1) == "fused_generate_kernel" or len(args) == 3:
        return m.group(1), tuple(args[:-1]), args[-1]
    return m.group(1), tuple(args), 0


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
    """Build the other tree's sources in parallel: {source: library}."""
    nvcc = build.find_nvcc()
    procs = {}
    for src in SOURCES:
        lib = os.path.join(out_dir, "lib" + os.path.splitext(src)[0] + ".so")
        procs[src] = (lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", lib, os.path.join(csrc, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {csrc}/{src}:\n{log}")
        libs[src] = lib
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
                   "only_here": []}
        for src in SOURCES:
            old = sass_functions(cuobjdump, other[src])
            new = {}
            for u in build.UNITS:
                if u.partition("@")[0] == src:
                    new.update(sass_functions(cuobjdump,
                                              build.library_path(u)))
            for key in sorted(new):
                name = f"{key[0]}<{', '.join(map(str, key[1]))}> prec {key[2]}"
                if key not in old:
                    summary["only_here"].append(name)
                    continue
                same = old[key] == new[key]
                summary["compared"] += 1
                summary["identical"] += same
                if not same:
                    summary["differ"].append(name)
                print(f"[sass] {src}: {name}: {len(old[key])} vs "
                      f"{len(new[key])} instructions, identical {same}",
                      flush=True)
    print(json.dumps({"sass_compare": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
