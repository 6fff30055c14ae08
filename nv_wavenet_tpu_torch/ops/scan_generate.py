"""Plain PyTorch step generator: the whole autoregressive loop as a Python
loop over samples, one eager torch op at a time.

The port's counterpart of `nv_wavenet_tpu/ops/scan_generate.py`, and the
plain version of kernels K1 and K5 (`csrc/persistent.cu`): the CPU path runs
it, and the chip smoke test holds the kernels against it on the card.  With
per-row clocks and lengths (K5, the ragged feeds of the serving path) each
row advances its own FIFO phase and freezes once its length is reached.  It
runs on any
device; on CUDA its matrix products go to cuBLAS, which must run in full
fp32 (`torch.backends.cuda.matmul.allow_tf32` False, checked here).

The step math is the framework's canonical order (JAX package,
models/golden.py), so integer outputs match the golden model exactly:
  x0 = [tanh](embed[y_prev] + embed[A + y_cur])
  per layer: z = (x_{t-d} Wprev + x_t Wcur) + (dil_b + cond)
             h = tanh(z[:R]) * sigmoid(z[R:])
             x = (res + b_res) + x;  skip = (skip + sk) + b_skip
  relu(skip); zs = relu(skip Wzs + bzs); za = zs Wza + bza
  y = canonical sampler (or the first argmax).
The embedding is a gather plus one add: the JAX one-hot matmul selects one
row per table, so it yields exactly fl(row_prev + row_cur) too.

The ring is the plain [ring_size, B, R] FIFO buffer of
`WaveNetConfig.ring_offsets`, updated IN PLACE (torch may update in place
where the JAX version is functional; it saves a ring copy per step).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.ops import exact_math as em

MODES = ("sample", "argmax")


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
        raise NotImplementedError(
            f"mode {mode!r}: the port has {MODES}; forced (K2) and prng (K3) "
            f"are still to port")


def _check_fp32_matmul(t: torch.Tensor) -> None:
    if t.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the plain generator needs full-fp32 cuBLAS matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def step(params: Dict[str, torch.Tensor], cfg: WaveNetConfig,
         ring: torch.Tensor, y_prev: torch.Tensor, y_cur: torch.Tensor,
         t, zbias: torch.Tensor, sel_t: torch.Tensor, mode: str,
         dump: bool = False, live: Optional[torch.Tensor] = None):
    """One sample for every row.  zbias [L, B, 2R] is the term added to the
    dilated GEMM (dil_b + cond, or the pre-folded cond_pre).  `t` is the
    absolute index of the sample: an int shared by every row, or a [B] int64
    tensor of per-row clocks, each row then addressing its FIFOs by its own
    clock.  `live` [B] bool (per-row clocks only): rows outside it keep their
    FIFO content.  Writes the FIFOs in `ring` in place.  Returns (y [B]
    int32, aux or None)."""
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    dils, offs = cfg.dilations, cfg.ring_offsets
    x = embed_lookup(params["embed"], y_prev, y_cur, A, cfg.tanh_embed)
    skip = torch.zeros((x.shape[0], S), dtype=x.dtype, device=x.device)
    rows = (torch.arange(x.shape[0], device=x.device)
            if isinstance(t, torch.Tensor) else None)
    xt_dump, skip_dump = [], []
    for l in range(L):
        slot = offs[l] + (t & (dils[l] - 1))
        if rows is None:
            x_prev = ring[slot].clone()
            ring[slot] = x
        else:
            x_prev = ring[slot, rows]
            ring[slot, rows] = (x if live is None
                                else torch.where(live[:, None], x, x_prev))
        dw = params["dil_w"][l]
        z = (x_prev @ dw[:R]) + (x @ dw[R:])
        z = z + zbias[l]
        h = em.tanh(z[:, :R]) * em.sigmoid(z[:, R:])
        rs = h @ params["rs_w"][l]
        x = (rs[:, :R] + params["rs_b"][l, :R]) + x
        skip = (skip + rs[:, R:]) + params["rs_b"][l, R:]
        if dump:
            xt_dump.append(x)
            skip_dump.append(skip)
    skip = torch.clamp_min(skip, 0.0)
    zs = torch.clamp_min(skip @ params["out_w"] + params["out_b"], 0.0)
    za = zs @ params["end_w"] + params["end_b"]
    if mode != "argmax" or dump:
        e, cum = em.softmax_cumsum(za)
    if mode == "argmax":
        y = torch.argmax(za, dim=-1).to(torch.int32)
    else:
        y = em.select_from_cumsum(cum, sel_t[:, None], A, cfg.silence_bin)
    aux = None
    if dump:
        skip_dump[-1] = skip
        aux = {"xt": torch.stack(xt_dump), "skip": torch.stack(skip_dump),
               "zs": zs, "za": za, "p": em.softmax_p(e, cum)}
    return y, aux


def wavenet_step(params: Dict[str, torch.Tensor], state: GenState,
                 cond_t: torch.Tensor, sel_t: torch.Tensor,
                 cfg: WaveNetConfig, mode: str = "sample"):
    """One autoregressive sample for all utterances.  cond_t [L, B, 2R]
    (bias NOT folded: dil_b is added here); sel_t [B].  Returns
    (new_state, y [B] int32, aux dict of this step's activations)."""
    _check_mode(mode)
    _check_fp32_matmul(cond_t)
    zbias = params["dil_b"][:, None, :] + cond_t
    y, aux = step(params, cfg, state.ring, state.y_prev, state.y_cur, state.t,
                  zbias, sel_t, mode, dump=True)
    return GenState(state.ring, state.y_cur, y, state.t + 1), y, aux


def run_steps(params: Dict[str, torch.Tensor], cfg: WaveNetConfig, t0,
              cond_pre: torch.Tensor, sel: torch.Tensor, ring: torch.Tensor,
              y_state: torch.Tensor, n_valid, mode: str = "sample",
              dump: bool = False):
    """The sequential loop, with the contract of kernels K1 and K5: cond_pre
    [T, L, B, 2R] has dil_b folded in; sel [T, B]; the first n_valid steps
    run from absolute index t0, the rest emit 0 and touch no state.  Updates
    `ring` and `y_state` [2, B] (y_prev, y_cur) in place.  Returns
    (y [T, B] int32, aux) where aux is the last run step's activations when
    dump=True and a step ran, else None.

    K1: t0 and n_valid are ints shared by the batch.  K5: they are per-row
    tensors on cond_pre's device, t0 [B] int64 and n_valid [B] int32; row b
    runs its first n_valid[b] steps from its own clock t0[b], and at a step
    past its length (a dead row) keeps its FIFO content and y_state and
    emits 0.  Dead rows still flow through the batched products, and their
    results are discarded."""
    _check_mode(mode)
    _check_fp32_matmul(cond_pre)
    T, _, B, _ = cond_pre.shape
    per_row = isinstance(n_valid, torch.Tensor)
    if per_row and dump:
        raise ValueError("per-row lengths (K5) take no activation dump")
    y = torch.zeros((T, B), dtype=torch.int32, device=cond_pre.device)
    y_prev, y_cur = y_state[0].clone(), y_state[1].clone()
    aux: Optional[dict] = None
    for j in range(int(n_valid.max()) if per_row else n_valid):
        live = j < n_valid if per_row else None
        y_t, step_aux = step(params, cfg, ring, y_prev, y_cur, t0 + j,
                             cond_pre[j], sel[j], mode,
                             dump=dump and j == n_valid - 1, live=live)
        aux = step_aux if step_aux is not None else aux
        if per_row:
            y_t = torch.where(live, y_t, 0)
            y_prev, y_cur = (torch.where(live, y_cur, y_prev),
                             torch.where(live, y_t, y_cur))
        else:
            y_prev, y_cur = y_cur, y_t
        y[j] = y_t
    y_state[0] = y_prev
    y_state[1] = y_cur
    return y, aux


def generate(params: Dict[str, torch.Tensor], state: GenState,
             cond: torch.Tensor, selectors: torch.Tensor, cfg: WaveNetConfig,
             mode: str = "sample", dump: bool = False):
    """The full sequential loop.  cond [T, L, B, 2R] (raw: dil_b is added
    here, which rounds as the per-step dil_b + cond does); selectors [T, B].
    Returns (final_state, y [B, T] int32, aux) where aux is the last step's
    activations when dump=True, else None."""
    T = cond.shape[0]
    cond_pre = cond + params["dil_b"][None, :, None, :]
    y_state = torch.stack([state.y_prev, state.y_cur])
    y, aux = run_steps(params, cfg, state.t, cond_pre, selectors, state.ring,
                       y_state, T, mode, dump)
    return GenState(state.ring, y_state[0], y_state[1], state.t + T), y.T, aux
