"""The per-stage latency floor on the card: probe P5, the kernel
`stage_chain_kernel` of `csrc/probes.cu`, and its plain PyTorch version.

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
  * `rows` rows per CTA: the whole batch in one CTA (rows=B);
  * `weights`: "l2" (read from global memory, as K1 reads its weights) or
    "smem" (staged into shared memory once per launch, as K4 stages its
    stacks; D R 2R 4 bytes must fit, so D is cut to SMEM_D).

    python3 -m nv_wavenet_tpu_torch.tools.probe_stage [-T 16384] [-t 3]

It runs on the card and fails without one; it ends with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from nv_wavenet_tpu_torch.ops import exact_math as em
from nv_wavenet_tpu_torch.ops.ordered_matmul import ordered_matmul_plain
from nv_wavenet_tpu_torch.ops.persistent import SMEM_PER_BLOCK
from nv_wavenet_tpu_torch.utils import build
from nv_wavenet_tpu_torch.utils.profiling import card

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P] + [_I] * 8 + [_P]
# P5, one instance per precision: "exact" in the port's -fmad=false
# library, "fast" in the -fmad=true one
STAGE_CHAIN_KERNELS = {
    "exact": build.CudaKernel("probes.cu", "nvw_stage_chain", _ARGTYPES),
    "fast": build.CudaKernel(build.unit("probes.cu", "fmad"),
                             "nvw_stage_chain_fast", _ARGTYPES)}
PRECISIONS = tuple(STAGE_CHAIN_KERNELS)
WEIGHTS = ("l2", "smem")
SMEM_W_BYTES = 200 * 1024   # the most of W a CTA stages (weights="smem")
# the JAX probe's defaults (tools/probe_stage.py:88): the flagship's R and
# 2L+3 stages a step
B_DEFAULT, R_DEFAULT, D_DEFAULT = 16, 64, 43
SMEM_D = 6                  # 6 * 64 * 128 * 4 = 196,608 bytes of W


def smem_bytes(R: int, D: int, groups: int, rows: int, weights: str) -> int:
    """The dynamic shared memory of one CTA: x [groups, rows, R] and z
    [groups, rows, 2R], and W [D, R, 2R] under weights="smem"."""
    floats = groups * rows * 3 * R + (D * R * 2 * R if weights == "smem"
                                      else 0)
    return 4 * floats


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


def make_chain(B: int, R: int, D: int, T: int, precision: str = "exact",
               gate: bool = True, groups: int = 1, rows: int = 1,
               weights: str = "l2"):
    """Build `run(w [D, R, 2R], x [groups, B, R]) -> [groups, B, R]`: P5 on
    CUDA tensors (`rows` batch rows per CTA, W read from L2 or staged into
    shared memory), `chain_plain` on CPU tensors.  Raises ValueError for a
    shape the kernel does not take."""
    if precision not in PRECISIONS or weights not in WEIGHTS:
        raise ValueError(f"precision {precision!r} / weights {weights!r}: "
                         f"expected one of {PRECISIONS} / {WEIGHTS}")
    if min(B, R, D, groups, rows) < 1 or T < 0 or rows > B:
        raise ValueError(f"B={B}, R={R}, D={D}, T={T}, groups={groups}, "
                         f"rows={rows}: need positive sizes and rows <= B")
    if weights == "smem" and 4 * D * R * 2 * R > SMEM_W_BYTES:
        raise ValueError(f"weights='smem' stages W [D={D}, {R}, {2 * R}] "
                         f"({4 * D * R * 2 * R} bytes), more than "
                         f"{SMEM_W_BYTES}")
    smem = smem_bytes(R, D, groups, rows, weights)
    if smem > SMEM_PER_BLOCK - 1024:
        raise ValueError(f"{smem} bytes of shared memory per CTA: more than "
                         f"a block may use")
    kernel = STAGE_CHAIN_KERNELS[precision]

    def run(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dev = x.device
        build.check_tensor(w, "w", torch.float32, (D, R, 2 * R), dev)
        build.check_tensor(x, "x", torch.float32, (groups, B, R), dev)
        if dev.type == "cpu":
            return chain_plain(w, x, T, gate, precision)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        out = torch.empty_like(x)
        kernel(w.data_ptr(), x.data_ptr(), out.data_ptr(), B, R, D, T,
               groups, rows, int(gate), int(weights == "smem"),
               build.current_stream(dev))
        return out

    return run


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
            weights: str = "l2", iters: int = 3, quiet: bool = False
            ) -> float:
    """ns per stage of P5 on the card: CUDA events around `iters`
    back-to-back launches after one warm-up; prints it, and the aggregate
    ns per stage over the chains when groups > 1.  Fails without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_stage measures on a CUDA device and none "
                           "is available")
    dev = torch.device("cuda")
    run = make_chain(B, R, D, T, precision, gate, groups, rows, weights)
    w, x = chain_inputs(B, R, D, groups, dev)
    run(w, x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run(w, x)
    end.record()
    torch.cuda.synchronize()
    ns = start.elapsed_time(end) / iters * 1e6 / (T * D)
    if not quiet:
        print(f"{label:52s}: {ns:8.1f} ns/stage"
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
    return tuple(out)


# (label, measure's keyword arguments): the JAX probe's list
# (tools/probe_stage.py:105-123), then the locations of rows and of W
VARIANTS = _variants()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-T", "--steps", type=int, default=16384)
    ap.add_argument("-t", "--iters", type=int, default=3)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"chain probe: [B,R] @ [R,2R] dependent stages, D={D_DEFAULT} a "
          f"step, T={args.steps}", flush=True)
    results = {label: measure(label, T=args.steps, iters=args.iters, **kw)
               for label, kw in VARIANTS}
    print(card(), flush=True)
    return results


if __name__ == "__main__":
    main()
