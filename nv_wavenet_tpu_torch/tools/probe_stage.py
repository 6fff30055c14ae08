"""The per-stage latency floor on the card: probe P5, the kernels
`stage_chain_kernel`, `stage_stream_kernel` and `stage_cluster_kernel` of
`csrc/probes.cu`, and their plain PyTorch version.

The port's counterpart of `tools/probe_stage.py`.  Both generation tiers
are chains of dependent small products (K1: 2L+3 stages a step, K6: L+5),
so the time of one stage, x -> x W_d -> gate -> x at the flagship's
[B, R] @ [R, 2R] with R=64, is the floor under their step times.  The
probe strips the WaveNet math away and measures that stage alone; the cost
model of `utils/profiling.py` (`STAGE_NS`) takes its default from it.

Variants (`VARIANTS`, the JAX probe's list and the card's own axes):
  * precision "exact" (K1's column products and the canonical tanh and
    sigmoid, -fmad=false, bit for bit with `chain_plain`) or "fast" (FMA
    contraction, tanhf and __expf: the TPU probe's precision=DEFAULT);
  * the gate tanh * sigmoid on or off;
  * a batch sweep B = 1, 16, 64, 128 (one CTA per row: K1's layout);
  * `groups` independent chains advanced in one loop body (does a second
    chain ride free on a latency-bound stage?);
  * R=128;
  * `rows` rows per CTA (or per cluster): the whole batch in one (rows=B);
  * `weights`, the layout of W: "l2" (read from global memory inside the
    chain, as the first K1 read its weights), "smem" (staged into shared
    memory once per launch with plain loads; D R 2R 4 bytes must fit, so D
    is cut to SMEM_D), "stream" (K1's layout: W as k-quads streamed stage
    by stage by TMA through an mbarrier ring, `stream_plan`) or "cluster"
    (the cluster K6's layout: W held for the launch across a thread-block
    cluster of CLUSTER CTAs, each the column pairs (i, R+i) of its slice,
    x sent to every CTA by st.async stores that complete on the reader's
    mbarrier, `cluster_plan`).

    python3 -m nv_wavenet_tpu_torch.tools.probe_stage [-T 16384] [-t 3]
        [--weights stream cluster]

It runs on the card and fails without one; it ends with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses

import torch

from nv_wavenet_tpu_torch.ops import exact_math as em
from nv_wavenet_tpu_torch.ops.ordered_matmul import ordered_matmul_plain
from nv_wavenet_tpu_torch.ops.persistent import SMEM_PER_BLOCK
from nv_wavenet_tpu_torch.utils import build
from nv_wavenet_tpu_torch.utils.profiling import card

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P] + [_I] * 8 + [_P]
# w, x, out, B, R, D, T, G, rows, gate, np, ways (the stream's slots or the
# cluster's CTAs), smem, stream
_LAYOUT_ARGTYPES = [_P, _P, _P] + [_I] * 10 + [_P]


def _kernels(symbol: str, argtypes) -> dict:
    """One instance per precision: "exact" in the port's -fmad=false
    library, "fast" in the -fmad=true one (its symbol suffixed)."""
    return {"exact": build.CudaKernel("probes.cu", symbol, argtypes),
            "fast": build.CudaKernel(build.unit("probes.cu", "fmad"),
                                     symbol + "_fast", argtypes)}


# P5's kernels and their launch counts: the first design (weights "l2" and
# "smem") and the two Hopper layouts, each with its own counter
STAGE_CHAIN_KERNELS = _kernels("nvw_stage_chain", _ARGTYPES)
STAGE_STREAM_KERNELS = _kernels("nvw_stage_stream", _LAYOUT_ARGTYPES)
STAGE_CLUSTER_KERNELS = _kernels("nvw_stage_cluster", _LAYOUT_ARGTYPES)
PRECISIONS = tuple(STAGE_CHAIN_KERNELS)
WEIGHTS = ("l2", "smem", "stream", "cluster")
# the kernels of each layout, by precision
LAYOUT_KERNELS = {"l2": STAGE_CHAIN_KERNELS, "smem": STAGE_CHAIN_KERNELS,
                  "stream": STAGE_STREAM_KERNELS,
                  "cluster": STAGE_CLUSTER_KERNELS}
SMEM_W_BYTES = 200 * 1024   # the most of W a CTA stages (weights="smem")
# the JAX probe's defaults (tools/probe_stage.py:88): the flagship's R and
# 2L+3 stages a step
B_DEFAULT, R_DEFAULT, D_DEFAULT = 16, 64, 43
SMEM_D = 6                  # 6 * 64 * 128 * 4 = 196,608 bytes of W
MAX_WORKERS = 256           # threads that own column pairs (csrc kMaxWorkers)
MAX_SLOTS = 4               # the stream's ring: stages in flight at most
CLUSTER = 8                 # CTAs a cluster (csrc kClusterCTAs; portable)


def smem_bytes(R: int, D: int, groups: int, rows: int, weights: str) -> int:
    """The dynamic shared memory of one CTA of the first design: x [groups,
    rows, R] and z [groups, rows, 2R], and W [D, R, 2R] under
    weights="smem"."""
    floats = groups * rows * 3 * R + (D * R * 2 * R if weights == "smem"
                                      else 0)
    return 4 * floats


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """How a Hopper layout runs P5 at one shape (`stream_plan`,
    `cluster_plan`).  A worker thread owns the column pair (i, R+i) of
    `rows_per_worker` rows; `ways` is the stream's ring slots or the
    cluster's CTAs."""
    layout: str
    rows: int              # batch rows a CTA (stream) or a cluster
    rows_per_worker: int   # NP: 1, 2 or 4
    workers: int           # in warps, and the stream's producer warp
    ways: int
    smem_bytes: int


def _rows_per_worker(nr: int, pairs: int, what: str) -> int:
    """The fewest rows a worker owns so that every (row, pair) of the CTA
    has one and the workers fit a block."""
    for np_ in (1, 2, 4):
        if nr % np_ == 0 and nr // np_ * pairs <= MAX_WORKERS:
            return np_
    raise ValueError(f"{what}: {nr} rows of {pairs} column pairs a CTA need "
                     f"more than {MAX_WORKERS} threads at 4 rows a thread")


def _check_shape(B: int, R: int, D: int, groups: int, rows: int, what: str):
    if min(B, R, D, groups, rows) < 1 or B % rows:
        raise ValueError(f"{what}: B={B}, R={R}, D={D}, groups={groups}, "
                         f"rows={rows}: need positive sizes and rows "
                         f"dividing B")
    if R % 4:
        raise ValueError(f"{what}: R={R} is not a multiple of 4 (k-quads)")


def stream_plan(B: int, R: int, D: int, groups: int = 1,
                rows: int = 1) -> StagePlan:
    """Layout "stream": one CTA per `rows` batch rows (of each group), W_d
    (8 R^2 bytes) streamed into a ring of up to MAX_SLOTS slots beside two
    x buffers [groups rows, R].  Raises ValueError where fewer than two
    slots fit a block or the workers do not fit one."""
    _check_shape(B, R, D, groups, rows, "stream")
    nr = groups * rows
    np_ = _rows_per_worker(nr, R, "stream")
    x_bytes = 2 * nr * R * 4
    slot = 8 * R * R + 16          # a stage and its two mbarriers
    slots = min(MAX_SLOTS, (SMEM_PER_BLOCK - x_bytes) // slot)
    if slots < 2:
        raise ValueError(f"stream: a ring of W_d ({8 * R * R} bytes a "
                         f"stage) needs two slots beside {x_bytes} bytes of "
                         f"x; {SMEM_PER_BLOCK} fit a block")
    return StagePlan("stream", rows, np_, nr // np_ * R, slots,
                     slots * slot + x_bytes)


def cluster_plan(B: int, R: int, D: int, groups: int = 1,
                 rows: int = 1) -> StagePlan:
    """Layout "cluster": a cluster of CLUSTER CTAs per `rows` batch rows,
    CTA c holding its slice of every W_d (D R 2R 4 / CLUSTER bytes) and two
    x buffers [groups rows, R].  Raises ValueError where R does not divide
    by the cluster, the slices do not fit a block, or the workers do not fit
    one."""
    _check_shape(B, R, D, groups, rows, "cluster")
    if R % CLUSTER:
        raise ValueError(f"cluster: R={R} does not divide into {CLUSTER} "
                         f"CTAs a cluster")
    nr = groups * rows
    np_ = _rows_per_worker(nr, R // CLUSTER, "cluster")
    smem = D * R * 2 * R * 4 // CLUSTER + 2 * nr * R * 4 + 32
    if smem > SMEM_PER_BLOCK:
        per_cta = D * 8 * R * R // CLUSTER
        raise ValueError(f"cluster: D={D} slices of W ({per_cta} bytes a "
                         f"CTA) and x need {smem} bytes; {SMEM_PER_BLOCK} "
                         f"fit a block")
    return StagePlan("cluster", rows, np_, nr // np_ * (R // CLUSTER),
                     CLUSTER, smem)


def instance_shapes() -> dict:
    """A shape for each kernel instance the Hopper layouts compile, gate
    aside (csrc/probes.cu launch_np, launch_r): {(layout, NP, R): dict(B,
    R, groups, rows)}, NP the rows a worker and R the flagship's 64 (the
    unrolled instance) or 32 (the one for any R), each with two groups and
    two CTAs or clusters, at the most rows a CTA or cluster for which the
    plan gives NP.  chip_smoke.py phase 29 holds each on the card."""
    out = {}
    for layout in ("stream", "cluster"):
        for R in (R_DEFAULT, 32):
            pairs = R if layout == "stream" else R // CLUSTER
            for np_ in (1, 2, 4):
                rows = MAX_WORKERS * np_ // (2 * pairs)
                out[(layout, np_, R)] = dict(B=2 * rows, R=R, groups=2,
                                             rows=rows)
    return out


def cluster_columns(R: int, cluster: int) -> torch.Tensor:
    """The columns of z = x W_d that CTA c of a cluster owns, [cluster, 2R /
    cluster], in its local order: i for i in its slice c R/cluster ..
    (c+1) R/cluster - 1, then R + i for the same i, so the gate's two halves
    of a column pair sit on one CTA.  A single CTA (cluster=1) owns all 2R
    in order."""
    h = R // cluster
    i = torch.arange(R).reshape(cluster, h)
    return torch.cat([i, i + R], dim=1)


def quad_weights(w: torch.Tensor, cluster: int = 1) -> torch.Tensor:
    """W [D, R, 2R] laid out for the Hopper layouts, [cluster, D, R/4,
    2R/cluster, 4]: CTA c's columns (`cluster_columns`) as k-quads, element
    [c, d, q, n, e] = W[d, 4q + e, cluster_columns[c, n]], so one 16-byte
    load brings four k-terms of a column and a CTA's slices (a stage of the
    stream, at cluster=1) are contiguous."""
    D, R, _ = w.shape
    cols = cluster_columns(R, cluster).to(w.device)
    sel = w[:, :, cols]                                 # [D, R, cluster, 2h]
    return (sel.reshape(D, R // 4, 4, cluster, -1)
            .permute(3, 0, 1, 4, 2).contiguous())


def chain_plain(w: torch.Tensor, x: torch.Tensor, T: int, gate: bool = True,
                precision: str = "exact") -> torch.Tensor:
    """The plain version of P5 on any device: w [D, R, 2R], x [groups, B, R]
    float32 -> x after T steps of D stages, t folded into x at each step
    (x + (t == -1)).  "exact": K1's products (k in order, every product and
    sum rounded once) and the canonical tanh and sigmoid; "fast": torch's
    product and tanh and sigmoid."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    R = w.shape[1]
    x = x.clone()
    for t in range(T):
        x = x + float(t == -1)
        for d in range(w.shape[0]):
            if precision == "exact":
                z = ordered_matmul_plain(x.reshape(-1, R), w[d]).reshape(
                    *x.shape[:-1], 2 * R)
                zt, zs = z[..., :R], z[..., R:]
                x = em.tanh(zt) * em.sigmoid(zs) if gate else zt + zs
            else:
                z = torch.matmul(x, w[d])
                zt, zs = z[..., :R], z[..., R:]
                x = torch.tanh(zt) * torch.sigmoid(zs) if gate else zt + zs
    return x


def lay_out(w: torch.Tensor, weights: str) -> torch.Tensor:
    """W [D, R, 2R] as the layout `weights` reads it: `quad_weights` in one
    slice ("stream") or CLUSTER slices ("cluster"), W itself ("l2",
    "smem")."""
    if weights == "stream":
        return quad_weights(w)
    return quad_weights(w, CLUSTER) if weights == "cluster" else w


def make_chain(B: int, R: int, D: int, T: int, precision: str = "exact",
               gate: bool = True, groups: int = 1, rows: int = 1,
               weights: str = "l2"):
    """Build `run(w [D, R, 2R], x [groups, B, R]) -> [groups, B, R]`: P5 on
    CUDA tensors (`rows` batch rows per CTA, or per cluster of CLUSTER
    CTAs; W in the layout `weights`), `chain_plain` on CPU tensors.  Raises
    ValueError for a shape the kernel does not take, before any launch.
    `run.launch(lay_out(w, weights), x)` launches on CUDA tensors with W
    already laid out, unchecked (`measure` times it)."""
    if precision not in PRECISIONS or weights not in WEIGHTS:
        raise ValueError(f"precision {precision!r} / weights {weights!r}: "
                         f"expected one of {PRECISIONS} / {WEIGHTS}")
    if min(B, R, D, groups, rows) < 1 or T < 0 or rows > B:
        raise ValueError(f"B={B}, R={R}, D={D}, T={T}, groups={groups}, "
                         f"rows={rows}: need positive sizes and rows <= B")
    kernel = LAYOUT_KERNELS[weights][precision]
    if weights == "stream":
        plan = stream_plan(B, R, D, groups, rows)
    elif weights == "cluster":
        plan = cluster_plan(B, R, D, groups, rows)
    else:
        plan = None
        if weights == "smem" and 4 * D * R * 2 * R > SMEM_W_BYTES:
            raise ValueError(f"weights='smem' stages W [D={D}, {R}, "
                             f"{2 * R}] ({4 * D * R * 2 * R} bytes), more "
                             f"than {SMEM_W_BYTES}")
        smem = smem_bytes(R, D, groups, rows, weights)
        if smem > SMEM_PER_BLOCK - 1024:
            raise ValueError(f"{smem} bytes of shared memory per CTA: more "
                             f"than a block may use")

    def launch(wl: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x)
        stream = build.current_stream(x.device)
        if plan is None:
            kernel(wl.data_ptr(), x.data_ptr(), out.data_ptr(), B, R, D, T,
                   groups, rows, int(gate), int(weights == "smem"), stream)
        else:
            kernel(wl.data_ptr(), x.data_ptr(), out.data_ptr(), B, R, D, T,
                   groups, rows, int(gate), plan.rows_per_worker, plan.ways,
                   plan.smem_bytes, stream)
        return out

    def run(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dev = x.device
        build.check_tensor(w, "w", torch.float32, (D, R, 2 * R), dev)
        build.check_tensor(x, "x", torch.float32, (groups, B, R), dev)
        if dev.type == "cpu":
            return chain_plain(w, x, T, gate, precision)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        # a re-laid W, a copy of 8 D R^2 bytes, joins the launch on the
        # stream; the allocator reuses it only after the kernel
        return launch(lay_out(w, weights), x)

    run.launch = launch
    return run


def max_active_clusters(B: int, R: int, D: int, groups: int = 1,
                        rows: int = 1, precision: str = "exact",
                        gate: bool = True) -> int:
    """How many clusters of the cluster layout's instance the card holds at
    once (cudaOccupancyMaxActiveClusters); B / rows clusters beyond it run
    in further waves.  Launches nothing; needs a card."""
    plan = cluster_plan(B, R, D, groups, rows)
    lib = build.load(STAGE_CLUSTER_KERNELS[precision].source)
    fit = getattr(lib, "nvw_stage_cluster_fit"
                  + ("_fast" if precision == "fast" else ""))
    fit.argtypes = [_I] * 9 + [_P]
    fit.restype = ctypes.c_int
    n = ctypes.c_int(0)
    err = fit(B, R, D, groups, rows, int(gate), plan.rows_per_worker,
              plan.ways, plan.smem_bytes, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error {err}")
    return n.value


def chain_inputs(B: int, R: int, D: int, groups: int, device, seed: int = 0):
    """w uniform in [-0.15, 0.15) (the JAX probe's scale, which keeps the
    gateless chain from blowing up or dying out) and x in [-1, 1), from a
    seeded generator on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.rand((D, R, 2 * R), generator=gen, device=device) * 0.3 - 0.15
    x = torch.rand((groups, B, R), generator=gen, device=device) * 2 - 1
    return w, x


def measure(label: str, B: int = B_DEFAULT, R: int = R_DEFAULT,
            D: int = D_DEFAULT, T: int = 16384, precision: str = "exact",
            gate: bool = True, groups: int = 1, rows: int = 1,
            weights: str = "l2", iters: int = 3,
            quiet: bool = False) -> float:
    """ns per stage of P5 on the card: CUDA events around `iters`
    back-to-back launches after one warm-up, W laid out once before them;
    prints it, and the aggregate ns per stage over the chains when groups >
    1.  Fails without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_stage measures on a CUDA device and none "
                           "is available")
    dev = torch.device("cuda")
    run = make_chain(B, R, D, T, precision, gate, groups, rows, weights)
    w, x = chain_inputs(B, R, D, groups, dev)
    run(w, x)
    wl = lay_out(w, weights)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run.launch(wl, x)
    end.record()
    torch.cuda.synchronize()
    ns = start.elapsed_time(end) / iters * 1e6 / (T * D)
    if not quiet:
        print(f"{label:56s}: {ns:8.1f} ns/stage"
              + (f"  ({ns / groups:7.1f} ns/stage aggregate over {groups} "
                 f"chains)" if groups > 1 else ""), flush=True)
    return ns


def _variants():
    out = [("exact + gate (K1's stage)", {}),
           ("exact, no gate", dict(gate=False)),
           ("fast + gate (the TPU probe's DEFAULT)", dict(precision="fast")),
           ("fast, no gate", dict(precision="fast", gate=False))]
    for prec in ("fast", "exact"):
        out += [(f"batch sweep ({prec} + gate): B={b}",
                 dict(B=b, precision=prec)) for b in (1, 16, 64, 128)]
    out += [("fast + gate, groups=2", dict(precision="fast", groups=2)),
            ("fast + gate, groups=4", dict(precision="fast", groups=4)),
            ("exact + gate, groups=2", dict(groups=2)),
            ("R=128 fast + gate", dict(R=128, precision="fast"))]
    for prec in PRECISIONS:
        out += [(f"{prec} + gate, whole batch in one CTA (rows=16)",
                 dict(precision=prec, rows=B_DEFAULT)),
                (f"{prec} + gate, W in shared memory (D={SMEM_D})",
                 dict(precision=prec, weights="smem", D=SMEM_D)),
                (f"{prec} + gate, W in L2 (D={SMEM_D})",
                 dict(precision=prec, D=SMEM_D))]
    for lay, unit in (("stream", "CTA"), ("cluster", "cluster")):
        out += [(f"{lay}: exact + gate", dict(weights=lay)),
                (f"{lay}: fast + gate", dict(weights=lay, precision="fast")),
                (f"{lay}: exact, no gate", dict(weights=lay, gate=False))]
        out += [(f"{lay}: batch sweep (exact + gate): B={b}",
                 dict(weights=lay, B=b)) for b in (1, 16, 64, 128)]
        out += [(f"{lay}: exact + gate, whole batch in one {unit} "
                 f"(rows=16)", dict(weights=lay, rows=B_DEFAULT))]
    # twice the work a stage on one ring: does the ring's ingest or the
    # chain bound the stream?
    out += [("stream: exact + gate, 2 rows a CTA",
             dict(weights="stream", rows=2))]
    # one wave: B=16 at one row a cluster is 16 clusters of 8, more than
    # the card holds at once (max_active_clusters)
    for prec in PRECISIONS:
        out += [(f"cluster: {prec} + gate, 2 rows a cluster",
                 dict(weights="cluster", rows=2, precision=prec))]
    return tuple(out)


# (label, measure's keyword arguments): the JAX probe's list
# (tools/probe_stage.py:105-123), then the locations of rows and of W
VARIANTS = _variants()


def floor_labels() -> tuple:
    """The variants `utils/profiling.STAGE_NS` is the least of: one exact
    chain with the gate at B=16, R=64, D=43, in any layout and any rows a
    CTA or cluster."""
    return tuple(label for label, kw in VARIANTS
                 if kw.get("precision", "exact") == "exact"
                 and kw.get("gate", True) and kw.get("groups", 1) == 1
                 and kw.get("B", B_DEFAULT) == B_DEFAULT
                 and kw.get("R", R_DEFAULT) == R_DEFAULT
                 and kw.get("D", D_DEFAULT) == D_DEFAULT)


def stage_floor(results: dict) -> tuple:
    """(label, ns) of the least exact stage among `floor_labels` measured in
    `results` ({label: ns per stage})."""
    return min(((label, results[label]) for label in floor_labels()
                if label in results), key=lambda kv: kv[1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-T", "--steps", type=int, default=16384)
    ap.add_argument("-t", "--iters", type=int, default=3)
    ap.add_argument("--weights", nargs="+", choices=WEIGHTS, default=WEIGHTS,
                    help="the layouts of W to measure (default: all)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"chain probe: [B,R] @ [R,2R] dependent stages, D={D_DEFAULT} a "
          f"step, T={args.steps}", flush=True)
    results = {label: measure(label, T=args.steps, iters=args.iters, **kw)
               for label, kw in VARIANTS
               if kw.get("weights", "l2") in args.weights}
    if set(floor_labels()) & set(results):
        label, ns = stage_floor(results)
        print(f"the least exact stage at B={B_DEFAULT}, D={D_DEFAULT}: "
              f"{ns:.1f} ns ({label})", flush=True)
    print(card(), flush=True)
    return results


if __name__ == "__main__":
    main()
