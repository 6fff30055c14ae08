"""K1 card-wide's grid barrier alone on the card: probe P6,
`barrier_probe_kernel` of `csrc/probes.cu`.

K1 card-wide (`csrc/wide_generate.cu`) passes 2L + 2 grid barriers a step
(62 at the wide vocoder's 30 layers), and its stamps count a barrier's wait
with the skew between the CTAs' arrivals in it.  The probe runs K barriers
with no work between them over a cooperative grid of one CTA an SM, in
clusters, so that what is left is the barrier's own cost:

  * form "flat": K1 card-wide's barrier (`csrc/grid_barrier.cuh`): every
    CTA adds its arrival to one count in global memory and polls it;
  * form "two_level": a cluster's CTAs gather on their leader's mbarrier,
    one global arrival and one global poller a cluster, the cluster released
    through its CTAs' shared memory (`csrc/probes.cu`);
  * each with and without a second waiting thread a CTA (the analogue of the
    kernel's prev warps, which wait for an earlier barrier beside the
    chain): on the count (flat) or on the CTA's own word (two levels).

The clusters are K1 card-wide's (`cluster_of`): the most CTAs, 8 at most,
that divide the grid and whose clusters the card holds all at once; then,
for the two-level form, each smaller power of two down to 1.  Each case
runs one warm-up launch, then `--launches` launches timed one by one with
CUDA events, and reports ns a barrier for each; after every launch the
count must read `expected_count`.  Prints how many clusters of 8, 4, 2 and
1 the card holds, one JSON line a case, then the card's name and power
limit.

    python3 -m nv_wavenet_tpu_torch.tools.barrier_probe [--ctas 128]
        [--clusters N ...] [-K 15872] [--launches 3]

It runs on the card and fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from nv_wavenet_tpu_torch.utils import build
from nv_wavenet_tpu_torch.utils.profiling import card

FORMS = ("flat", "two_level")
# count, ctas, cluster, K, form (FORMS' index), poller, stream
BARRIER_PROBE = build.CudaKernel(
    "probes.cu", "nvw_barrier_probe",
    [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# cluster, out: how many such clusters the card holds at once
BARRIER_PROBE_FIT = build.CudaKernel(
    "probes.cu", "nvw_barrier_probe_fit",
    [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
# K1 card-wide's grid at the wide vocoder's widths, and one 256-step
# launch's barriers there (30 layers: 62 a step)
CTAS, BARRIERS = 128, 256 * 62


def expected_count(form: str, K: int, ctas: int, cluster: int) -> int:
    """The global count after K barriers: every CTA's arrival (flat), or one
    a cluster (two levels)."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, not {form!r}")
    return K * (ctas // cluster if form == "two_level" else ctas)


def cluster_sizes(ctas: int, held: dict) -> list:
    """K1 card-wide's cluster for a grid of `ctas` (the most CTAs, 8 at
    most, that divide it and of whose clusters the card holds `held[n]` at
    once, enough for the grid), then each smaller power of two."""
    for n in (8, 4, 2, 1):
        if ctas % n == 0 and held[n] * n >= ctas:
            return [m for m in (8, 4, 2, 1) if m <= n]
    raise ValueError(f"the card holds no grid of {ctas} CTAs in clusters")


def cases(clusters) -> list:
    """(form, cluster, poller) of a run: both forms at the first cluster
    size, the two-level one at the others, each with and without the second
    waiting thread."""
    first, rest = clusters[0], clusters[1:]
    return ([(form, first, poller) for form in FORMS
             for poller in (False, True)]
            + [("two_level", c, poller) for c in rest
               for poller in (False, True)])


def measure(form: str, cluster: int, poller: bool, ctas: int = CTAS,
            K: int = BARRIERS, launches: int = 3) -> dict:
    """ns a barrier of each of `launches` timed launches (after a warm-up)."""
    if not torch.cuda.is_available():
        raise RuntimeError("barrier_probe measures on a CUDA device and none "
                           "is available")
    dev = torch.device("cuda")
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = build.current_stream(dev)
    want = expected_count(form, K, ctas, cluster)
    ns = []
    for i in range(launches + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        BARRIER_PROBE(count.data_ptr(), ctas, cluster, K, FORMS.index(form),
                      int(poller), stream)
        end.record()
        torch.cuda.synchronize()
        got = int(count.item())
        if got != want:
            raise RuntimeError(f"{form} barrier, clusters of {cluster}: the "
                               f"count read {got} after {K} barriers, not "
                               f"{want}")
        if i:
            ns.append(start.elapsed_time(end) * 1e6 / K)
    return {"form": form, "cluster": cluster, "poller": poller,
            "ctas": ctas, "barriers": K, "ns_per_barrier": ns}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ctas", type=int, default=CTAS)
    ap.add_argument("--clusters", type=int, nargs="+",
                    help="cluster sizes: both forms at the first, the "
                         "two-level form at the others (default: K1 "
                         "card-wide's, then each smaller power of two)")
    ap.add_argument("-K", "--barriers", type=int, default=BARRIERS)
    ap.add_argument("--launches", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("barrier_probe measures on a CUDA device and none "
                           "is available")
    held = {}
    for n in (8, 4, 2, 1):
        out = ctypes.c_int(0)
        BARRIER_PROBE_FIT(n, ctypes.pointer(out))
        held[n] = out.value
    print(json.dumps({"clusters_held": held}), flush=True)
    clusters = args.clusters or cluster_sizes(args.ctas, held)
    results = []
    for form, cluster, poller in cases(clusters):
        res = measure(form, cluster, poller, args.ctas, args.barriers,
                      args.launches)
        print(json.dumps(res), flush=True)
        results.append(res)
    print(card(), flush=True)
    return results


if __name__ == "__main__":
    main()
