"""Plain PyTorch step generator: the whole autoregressive loop as a Python
loop over samples, one eager torch op at a time.

The port's counterpart of `nv_wavenet_tpu/ops/scan_generate.py`, and the
plain version of kernels K1, K2, K3 and K5 (`ops/persistent.py`): the CPU
path runs it, and the chip smoke test holds the kernels against it on the
card.  With per-row clocks and lengths (K5, the ragged feeds of the serving
path) each row advances its own FIFO phase and freezes once its length is
reached.  Mode "forced" (K2) consumes given symbols and emits the per-step
probabilities; mode "prng" (K3) is mode "sample" fed the Philox selectors of
`prng_uniform_sel`.  It runs on any device; on CUDA its matrix products go
to cuBLAS, which must run in full fp32
(`torch.backends.cuda.matmul.allow_tf32` False, checked here).

The step math is the framework's canonical order (JAX package,
models/golden.py), so integer outputs match the golden model exactly:
  x0 = [tanh](embed[y_prev] + embed[A + y_cur])
  per layer: z = (x_{t-d} Wprev + x_t Wcur) + (dil_b + cond)
             h = tanh(z[:R]) * sigmoid(z[R:])
             x = (res + b_res) + x;  skip = (skip + sk) + b_skip
  relu(skip); zs = relu(skip Wzs + bzs); za = zs Wza + bza
  y = canonical sampler (or the first argmax, or the forced symbol).
The embedding is a gather plus one add: the JAX one-hot matmul selects one
row per table, so it yields exactly fl(row_prev + row_cur) too.

The ring is the plain [ring_size, B, R] FIFO buffer of
`WaveNetConfig.ring_offsets`, updated IN PLACE (torch may update in place
where the JAX version is functional; it saves a ring copy per step).

Precision (`PRECISIONS`, one definition for the whole port; JAX
`ops/persistent.py:550, 553, 589-591`, `ops/scan_generate.py:94-142`):
  * "exact": fp32 throughout, the contract above;
  * "fast" (fast_math): the TPU's DEFAULT matrix precision.  Every weight
    matrix that enters a product (`PRODUCT_PARAMS`) is rounded to bf16
    (`product_view`, after the temperature and the storage's values) and
    every activation as it enters one: x_{t-d}, x, h, relu(skip), zs.  A
    bf16 x bf16 product is exact in fp32 and the sums stay fp32; biases and
    cond_pre are never rounded; x and the ring stay fp32;
  * "bf16" (compute_dtype=bfloat16): "fast", and x is stored rounded after
    the embedding's tanh and after every residual add (done in fp32), and
    the ring holds bf16.
The dumps hold skip and zs before their rounding, xt as stored.  JAX's scan
rounds the embedding only after its lookup (its one-hot product runs at
DEFAULT precision, which XLA:CPU computes as fp32); the kernels of both
packages round the table first, and so does the port everywhere.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.ops import exact_math as em

MODES = ("sample", "argmax", "forced", "prng")
PRECISIONS = ("exact", "fast", "bf16")
# the canonical params that enter products: bf16-rounded unless "exact"
PRODUCT_PARAMS = ("embed", "dil_w", "rs_w", "out_w", "end_w")

# Philox4x32-10 (Salmon et al., SC '11), the constants of Random123
PHILOX_M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
PHILOX_W = (np.uint64(0x9E3779B9), np.uint64(0xBB67AE85))
_U32 = np.uint64(0xFFFFFFFF)


def philox4x32(ctr, key):
    """Philox4x32-10 on numpy arrays of 32-bit words held in uint64 (a
    32 x 32-bit product fits; torch's int64 would overflow): ctr is 4
    words, key 2, broadcast together.  Returns the 4 output words."""
    c0, c1, c2, c3 = (np.asarray(c, np.uint64) for c in ctr)
    k0, k1 = (np.asarray(k, np.uint64) for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & _U32, (k1 + PHILOX_W[1]) & _U32
        p0, p1 = PHILOX_M[0] * c0, PHILOX_M[1] * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & _U32,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & _U32)
    return c0, c1, c2, c3


def prng_uniform_sel(seed: int, t, B: int) -> np.ndarray:
    """Kernel K3's selectors: the uniform of absolute sample index t and
    batch row b is Philox4x32-10 with counter (t_lo, t_hi, b, 0) and key
    (seed_lo, seed_hi), word 0's top 24 bits times 2^-24 (the mapping of
    the TPU kernel's `prng_uniform_sel`, JAX `ops/persistent.py:74-83`,
    whose hardware bits it cannot reproduce).  Keyed on the absolute index,
    so draws do not depend on chunking.  t: an int >= 0 -> [B] float32, or
    a 1-D array -> [len(t), B]."""
    t = np.asarray(t, np.uint64)[..., None]
    seed = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    word0 = philox4x32(
        (t & _U32, t >> np.uint64(32), np.arange(B, dtype=np.uint64), 0),
        (seed & _U32, seed >> np.uint64(32)))[0]
    return ((word0 >> np.uint64(8)).astype(np.float32)
            * np.float32(2.0 ** -24))


def precision(compute_dtype=torch.float32, fast_math: bool = False) -> str:
    """The precision of a dispatch (`PRECISIONS`): "bf16" under
    compute_dtype=torch.bfloat16 (with or without fast_math: both are
    DEFAULT precision in JAX), "fast" under fast_math, else "exact".
    Raises ValueError for any other compute_dtype."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {compute_dtype}")
    if compute_dtype == torch.bfloat16:
        return "bf16"
    return "fast" if fast_math else "exact"


def ring_dtype(prec: str) -> torch.dtype:
    """The FIFO ring's dtype under a precision: bf16 only under "bf16"."""
    return torch.bfloat16 if prec == "bf16" else torch.float32


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """The fp32 value of t rounded to bf16 (round to nearest even)."""
    return t.to(torch.bfloat16).to(torch.float32)


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def roundings(prec: str):
    """(operand, stored): what an activation becomes as it enters a
    product, and what the residual stream x is stored as, under `prec`."""
    _check_precision(prec)
    return (_identity if prec == "exact" else round_bf16,
            round_bf16 if prec == "bf16" else _identity)


def product_view(params: Dict[str, torch.Tensor], prec: str
                 ) -> Dict[str, torch.Tensor]:
    """params with the matrices that enter products (`PRODUCT_PARAMS`)
    rounded to bf16 under "fast" and "bf16"; the params themselves under
    "exact".  Idempotent."""
    _check_precision(prec)
    if prec == "exact":
        return params
    return {k: round_bf16(v) if k in PRODUCT_PARAMS else v
            for k, v in params.items()}


def _check_precision(prec: str) -> None:
    if prec not in PRECISIONS:
        raise ValueError(f"unknown precision {prec!r}; the port has "
                         f"{PRECISIONS}")


class GenState(NamedTuple):
    """Carried generation state.

    ring:   [ring_size, B, R] per-layer dilation FIFOs (updated in place).
    y_prev, y_cur: [B] int32 last two emitted symbols.
    t:      absolute sample index (drives FIFO slot addressing, so state
            survives chunked calls).
    """
    ring: torch.Tensor
    y_prev: torch.Tensor
    y_cur: torch.Tensor
    t: int


def init_state(cfg: WaveNetConfig, batch: int, device,
               dtype=torch.float32) -> GenState:
    return GenState(
        ring=torch.zeros((cfg.ring_size, batch, cfg.R), dtype=dtype,
                         device=device),
        y_prev=torch.full((batch,), cfg.silence_bin, dtype=torch.int32,
                          device=device),
        y_cur=torch.full((batch,), cfg.silence_bin, dtype=torch.int32,
                         device=device),
        t=0)


def embed_lookup(embed: torch.Tensor, y_prev: torch.Tensor,
                 y_cur: torch.Tensor, A: int, tanh_embed: bool) -> torch.Tensor:
    """x0 = [tanh](embed_prev[y_prev] + embed_cur[y_cur]) from the fused
    [2A, R] table."""
    x = embed[y_prev.long()] + embed[A + y_cur.long()]
    return em.tanh(x) if tanh_embed else x


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the port has {MODES}")


def check_ring(ring: torch.Tensor, prec: str) -> None:
    """Raise ValueError unless `ring` has the dtype of precision `prec`."""
    _check_precision(prec)
    if ring.dtype != ring_dtype(prec):
        raise ValueError(f"precision {prec!r} keeps its FIFO ring as "
                         f"{ring_dtype(prec)}, got {ring.dtype}")


def _check_fp32_matmul(t: torch.Tensor) -> None:
    if t.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the plain generator needs full-fp32 cuBLAS matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def step(params: Dict[str, torch.Tensor], cfg: WaveNetConfig,
         ring: torch.Tensor, y_prev: torch.Tensor, y_cur: torch.Tensor,
         t, zbias: torch.Tensor, sel_t: torch.Tensor, mode: str,
         dump: bool = False, live: Optional[torch.Tensor] = None,
         prec: str = "exact"):
    """One sample for every row.  zbias [L, B, 2R] is the term added to the
    dilated GEMM (dil_b + cond, or the pre-folded cond_pre).  `t` is the
    absolute index of the sample: an int shared by every row, or a [B] int64
    tensor of per-row clocks, each row then addressing its FIFOs by its own
    clock.  `live` [B] bool (per-row clocks only): rows outside it keep their
    FIFO content.  sel_t [B]: the uniforms (modes "sample" and "prng"), or
    the symbols to emit as exact small-integer floats (mode "forced").
    `prec` (`PRECISIONS`): params must be `product_view(params, prec)`; the
    activations are rounded here, and the ring is bf16 under "bf16".
    Writes the FIFOs in `ring` in place.  Returns (y [B] int32, aux or None,
    za [B, A], p [B, A] in mode "forced" or with dump, else None)."""
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    dils, offs = cfg.dilations, cfg.ring_offsets
    op, st = roundings(prec)
    x = st(embed_lookup(params["embed"], y_prev, y_cur, A, cfg.tanh_embed))
    skip = torch.zeros((x.shape[0], S), dtype=x.dtype, device=x.device)
    rows = (torch.arange(x.shape[0], device=x.device)
            if isinstance(t, torch.Tensor) else None)
    xt_dump, skip_dump = [], []
    for l in range(L):
        slot = offs[l] + (t & (dils[l] - 1))
        if rows is None:
            x_prev = ring[slot].to(torch.float32, copy=True)
            ring[slot] = x.to(ring.dtype)
        else:
            x_prev = ring[slot, rows].to(torch.float32)
            ring[slot, rows] = (x if live is None else torch.where(
                live[:, None], x, x_prev)).to(ring.dtype)
        dw = params["dil_w"][l]
        z = (op(x_prev) @ dw[:R]) + (op(x) @ dw[R:])
        z = z + zbias[l]
        h = em.tanh(z[:, :R]) * em.sigmoid(z[:, R:])
        rs = op(h) @ params["rs_w"][l]
        x = st((rs[:, :R] + params["rs_b"][l, :R]) + x)
        skip = (skip + rs[:, R:]) + params["rs_b"][l, R:]
        if dump:
            xt_dump.append(x)
            skip_dump.append(skip)
    skip = torch.clamp_min(skip, 0.0)
    zs = torch.clamp_min(op(skip) @ params["out_w"] + params["out_b"], 0.0)
    za = op(zs) @ params["end_w"] + params["end_b"]
    if mode != "argmax" or dump:
        e, cum = em.softmax_cumsum(za)
    if mode == "argmax":
        y = torch.argmax(za, dim=-1).to(torch.int32)
    elif mode == "forced":
        y = sel_t.to(torch.int32)
    else:
        y = em.select_from_cumsum(cum, sel_t[:, None], A, cfg.silence_bin)
    p = em.softmax_p(e, cum) if dump or mode == "forced" else None
    aux = None
    if dump:
        skip_dump[-1] = skip
        aux = {"xt": torch.stack(xt_dump), "skip": torch.stack(skip_dump),
               "zs": zs, "za": za, "p": p}
    return y, aux, za, p


def wavenet_step(params: Dict[str, torch.Tensor], state: GenState,
                 cond_t: torch.Tensor, sel_t: torch.Tensor,
                 cfg: WaveNetConfig, mode: str = "sample",
                 forced_y_t: Optional[torch.Tensor] = None, seed: int = 0,
                 prec: str = "exact"):
    """One autoregressive sample for all utterances.  cond_t [L, B, 2R]
    (bias NOT folded: dil_b is added here); sel_t [B]; forced_y_t [B]: the
    symbols the chain consumes instead of its own samples; mode "prng"
    draws `prng_uniform_sel(seed, state.t, B)`; prec: `PRECISIONS` (the
    ring's dtype must be `ring_dtype(prec)`).  Returns (new_state, y [B]
    int32, aux dict of this step's activations)."""
    _check_mode(mode)
    _check_fp32_matmul(cond_t)
    check_ring(state.ring, prec)
    params = product_view(params, prec)
    if forced_y_t is not None:
        mode, sel_t = "forced", forced_y_t.to(torch.float32)
    elif mode == "prng":
        sel_t = torch.from_numpy(prng_uniform_sel(
            seed, state.t, cond_t.shape[1])).to(cond_t.device)
    zbias = params["dil_b"][:, None, :] + cond_t
    y, aux, _, _ = step(params, cfg, state.ring, state.y_prev, state.y_cur,
                        state.t, zbias, sel_t, mode, dump=True, prec=prec)
    return GenState(state.ring, state.y_cur, y, state.t + 1), y, aux


def run_steps(params: Dict[str, torch.Tensor], cfg: WaveNetConfig, t0,
              cond_pre: torch.Tensor, sel: torch.Tensor, ring: torch.Tensor,
              y_state: torch.Tensor, n_valid, mode: str = "sample",
              dump: bool = False, seed: int = 0,
              record: Optional[str] = None, prec: str = "exact"):
    """The sequential loop, with the contract of kernels K1, K2, K3 and K5
    in each precision `prec` (`PRECISIONS`; the weights are rounded here,
    `product_view`, and the ring's dtype must be `ring_dtype(prec)`):
    cond_pre [T, L, B, 2R] has dil_b folded in; sel [T, B]; the first
    n_valid steps run from absolute index t0, the rest emit 0 and touch no
    state.  Updates `ring` and `y_state` [2, B] (y_prev, y_cur) in place.
    Mode "forced": sel carries the symbols to emit; mode "prng": sel is not
    read, step j draws `prng_uniform_sel(seed, t0 + j, B)`.  record "p"
    (mode "forced") or "za": also keep that per-step [T, B, A] sequence,
    zero past n_valid.  Returns (y [T, B] int32, aux, seq) where aux is the
    last run step's activations when dump=True and a step ran, else None,
    and seq the recorded sequence or None.

    K1, K2, K3: t0 and n_valid are ints shared by the batch.  K5: they are
    per-row tensors on cond_pre's device, t0 [B] int64 and n_valid [B]
    int32 (mode "sample" only); row b runs its first n_valid[b] steps from
    its own clock t0[b], and at a step past its length (a dead row) keeps
    its FIFO content and y_state and emits 0.  Dead rows still flow through
    the batched products, and their results are discarded."""
    _check_mode(mode)
    _check_fp32_matmul(cond_pre)
    check_ring(ring, prec)
    params = product_view(params, prec)
    T, _, B, _ = cond_pre.shape
    per_row = isinstance(n_valid, torch.Tensor)
    if per_row and (dump or mode != "sample" or record is not None):
        raise ValueError("per-row lengths (K5) run mode 'sample' without "
                         "dump")
    if record not in (None, "p", "za") or (record == "p"
                                           and mode != "forced"):
        raise ValueError(f"record={record!r}: 'p' (mode 'forced') or 'za'")
    if mode == "prng":
        sel = torch.from_numpy(prng_uniform_sel(
            seed, np.arange(t0, t0 + n_valid), B)).to(cond_pre.device)
    dev = cond_pre.device
    y = torch.zeros((T, B), dtype=torch.int32, device=dev)
    seq = (torch.zeros((T, B, cfg.A), dtype=torch.float32, device=dev)
           if record else None)
    y_prev, y_cur = y_state[0].clone(), y_state[1].clone()
    aux: Optional[dict] = None
    for j in range(int(n_valid.max()) if per_row else n_valid):
        live = j < n_valid if per_row else None
        y_t, step_aux, za, p = step(params, cfg, ring, y_prev, y_cur, t0 + j,
                                    cond_pre[j], sel[j], mode,
                                    dump=dump and j == n_valid - 1,
                                    live=live, prec=prec)
        aux = step_aux if step_aux is not None else aux
        if record:
            seq[j] = p if record == "p" else za
        if per_row:
            y_t = torch.where(live, y_t, 0)
            y_prev, y_cur = (torch.where(live, y_cur, y_prev),
                             torch.where(live, y_t, y_cur))
        else:
            y_prev, y_cur = y_cur, y_t
        y[j] = y_t
    y_state[0] = y_prev
    y_state[1] = y_cur
    return y, aux, seq


def generate(params: Dict[str, torch.Tensor], state: GenState,
             cond: torch.Tensor, selectors: torch.Tensor, cfg: WaveNetConfig,
             mode: str = "sample", dump: bool = False,
             forced_y: Optional[torch.Tensor] = None,
             return_za: bool = False, seed: int = 0,
             compute_dtype=torch.float32, fast_math: bool = False):
    """The full sequential loop.  cond [T, L, B, 2R] (raw: dil_b is added
    here, which rounds as the per-step dil_b + cond does); selectors [T, B];
    forced_y: optional [T, B] int teacher-forcing symbols, which the chain
    consumes instead of its own samples; seed: mode "prng"; compute_dtype
    and fast_math: the precision (`precision`; `init_state` with
    `ring_dtype` of it).  Returns (final_state, y [B, T] int32, aux) where
    aux is the last step's activations when dump=True, the per-step logits
    za [T, B, A] when return_za=True, else None."""
    prec = precision(compute_dtype, fast_math)
    T = cond.shape[0]
    cond_pre = cond + params["dil_b"][None, :, None, :]
    y_state = torch.stack([state.y_prev, state.y_cur])
    if forced_y is not None:
        mode, selectors = "forced", forced_y.to(torch.float32)
    record = "za" if return_za and not dump else None
    y, aux, za = run_steps(params, cfg, state.t, cond_pre, selectors,
                           state.ring, y_state, T, mode, dump, seed, record,
                           prec)
    return (GenState(state.ring, y_state[0], y_state[1], state.t + T), y.T,
            za if record else aux)
