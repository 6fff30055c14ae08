"""Time-parallel teacher-forced scorer: the per-step output distributions of
a KNOWN symbol trajectory, computed layer by layer over the whole window
instead of sample by sample.

The port's counterpart of `nv_wavenet_tpu/ops/score_parallel.py`.  Teacher
forcing breaks the autoregressive dependence: every step's inputs (the
previous symbols, the conditioning) are known up front, so each layer's
products run over all T * B rows at once, L layer passes instead of
T * (2L + 3) dependent small products.  It reads and writes the generation
kernels' FIFO ring ([ring_size, B, R], `ops/persistent.init_ring`), so it
scores mid-stream from any generation state and leaves the state generation
would leave: scoring in chunks equals one full-window score, and score ->
generate handoffs continue exactly.  It is also the verify pass of
speculative decoding (with `return_xt` and `make_state_committer`).

Exactness: the step math is K1's (`csrc/generic_generate.cu`), term for term:
  z = (x_{t-d} Wprev + x_t Wcur) + cond_pre,  h = tanh(z[:R]) * sigmoid(z[R:])
  x = (res + b_res) + x,  skip = (skip + sk) + b_skip,
  zs = relu(relu(skip) Wzs + bzs),  za = zs Wza + bza,  p = canonical softmax.
On the card the products run in K1's summation order (kernel K7,
`ops/ordered_matmul.py`): a layer's dilated product, its conditioning and
the gate in one launch of K7's gate entry (`ordered_gate`), its res/skip
product with the residual and skip adds in one launch of the res/skip
entry (`ordered_res_skip`), the output stack through `ordered_matmul`; the
embedding's tanh in the exact-math kernel K0a and the softmax in K0c; so
p_seq, the ring and y_state equal the forced kernel K2's bit for bit.  On
the CPU the plain versions of the three run.

compute_dtype=torch.bfloat16 (JAX `ops/score_parallel.py:46, 105-167`) is
K2's "bf16" precision term for term (`scan_generate.PRECISIONS`): the
matrices that enter products rounded to bf16 (`scan_generate.product_view`),
x stored rounded after the embedding and after each residual add, h,
relu(skip) and zs rounded as they enter products, the ring bf16; K7 sums
the exact bf16 x bf16 products in K2's order, so the scorer still equals
K2 of that precision bit for bit.  (JAX's scorer gathers the embedding
before rounding it; its kernels, K2 and this scorer round the table first.)
The JAX engine scores in fp32 under fast_math, and so does the port.

Layer l's FIFO is the contiguous slot block [offs[l], offs[l] + d_l) of the
ring, holding x^l at time tau in slot offs[l] + (tau mod d_l): the history
is that block rotated by t0 mod d_l, and the write-back the window's last
d_l layer inputs rotated back.  The JAX package's lane-packed ring needs a
column block per layer too; here each layer owns whole slots.  `ring` and
`y_state` are updated IN PLACE and returned, as the generation kernels do.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.ops import exact_math as em
from nv_wavenet_tpu_torch.ops import scan_generate
from nv_wavenet_tpu_torch.ops.ordered_matmul import (ordered_gate,
                                                     ordered_matmul,
                                                     ordered_res_skip)
from nv_wavenet_tpu_torch.utils import build


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] x [K, N] -> [T * B, N] through K7 (plain on the CPU)."""
    return ordered_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)


def _write_back(ring: torch.Tensor, off: int, d: int, x_full: torch.Tensor,
                t_end: int, nv: int) -> None:
    """Slots [off, off + d) of `ring` get the d layer inputs x_full[nv:nv+d]
    (times t_end - d .. t_end - 1), each at its residue slot tau mod d, in
    the ring's dtype."""
    ring[off:off + d] = torch.roll(x_full[nv:nv + d], t_end % d,
                                   0).to(ring.dtype)


def _history(ring: torch.Tensor, off: int, d: int, t0: int) -> torch.Tensor:
    """Layer inputs at times t0 - d .. t0 - 1 from slots [off, off + d),
    as fp32."""
    return torch.roll(ring[off:off + d], -(t0 % d), 0).to(torch.float32)


def make_parallel_scorer(cfg: WaveNetConfig, batch: int,
                         compute_dtype=torch.float32,
                         prefold_cond: bool = False, return_xt: bool = False,
                         return_za: bool = False):
    """Build `score(params, t0, cond, y, ring, y_state, n_valid=None)`.

    params: canonical float32 tensors (`models/params.canonical_to_torch`);
    t0: absolute index of the window's first step; cond: [T, L, B, 2R]
    conditioning (dil_b already added iff prefold_cond); y: [T, B] int, the
    symbols EMITTED at steps t0 .. t0+T-1; ring: [ring_size, B, R] FIFO
    state from `init_ring` (bf16 under compute_dtype=torch.bfloat16);
    y_state: [2, B] int32 = (y_{t0-2}, y_{t0-1}).
    All tensors on one device: CPU runs the plain versions, CUDA the
    kernels K7, K0a and K0c.

    Returns (p_seq [T, B, A], ring, y_state): ring and y_state, updated in
    place, are what the generation kernels carry after generating the same
    window.  return_xt=True appends xt [L+1, T, B, R] (each layer's input
    x^l_t and the last residual output: the state a speculative commit
    needs); return_za=True appends the logits za [T, B, A] (callers resolve
    tail log-probabilities by log_softmax on them).  n_valid (default T):
    ring and y_state then take only the first n_valid steps, the commit
    primitive of speculative decoding; rows >= n_valid of p_seq are still
    computed.
    """
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    B = batch
    dils, offs = cfg.dilations, cfg.ring_offsets
    prec = scan_generate.precision(compute_dtype)
    op, st = scan_generate.roundings(prec)   # an operand, the stored x

    def score(params: Dict[str, torch.Tensor], t0, cond: torch.Tensor,
              y: torch.Tensor, ring: torch.Tensor, y_state: torch.Tensor,
              n_valid: Optional[int] = None):
        T = y.shape[0]
        dev = cond.device
        build.check_tensor(ring, "ring", scan_generate.ring_dtype(prec),
                           (cfg.ring_size, B, R), dev)
        build.check_tensor(y_state, "y_state", torch.int32, (2, B), dev)
        if tuple(cond.shape) != (T, L, B, 2 * R) or cond.dtype != torch.float32:
            raise ValueError(f"cond: expected float32 {(T, L, B, 2 * R)}, "
                             f"got {cond.dtype} {tuple(cond.shape)}")
        if tuple(y.shape) != (T, B) or y.device != dev:
            raise ValueError(f"y: expected [T={T}, B={B}] on {dev}, got "
                             f"{tuple(y.shape)} on {y.device}")
        t0 = int(t0)
        nv = T if n_valid is None else int(n_valid)
        if t0 < 0 or not 0 <= nv <= T:
            raise ValueError(f"t0={t0} must be >= 0 and n_valid={nv} in "
                             f"[0, T={T}]")

        params = scan_generate.product_view(params, prec)
        # y_full[i] is the symbol emitted at time t0 - 2 + i
        y_full = torch.cat([y_state, y.to(torch.int32)], 0)   # [T+2, B]
        embed = params["embed"]
        x = embed[y_full[:T].long()] + embed[A + y_full[1:T + 1].long()]
        if cfg.tanh_embed:
            x = em.exact_fn("tanh", x)
        x = st(x)
        xt = []
        skip = torch.zeros((T * B, S), dtype=torch.float32, device=dev)
        for l in range(L):
            d, off = dils[l], offs[l]
            x_full = torch.cat([_history(ring, off, d, t0), x], 0)
            _write_back(ring, off, d, x_full, t0 + nv, nv)
            if return_xt:
                xt.append(x)
            dw = params["dil_w"][l]
            # z = (x_{t-d} Wprev + x_t Wcur) + (dil_b + cond), then the gate
            h = ordered_gate(op(x_full[:T]).reshape(-1, R).contiguous(),
                             op(x).reshape(-1, R).contiguous(), dw[:R],
                             dw[R:], cond[:, l],
                             None if prefold_cond else params["dil_b"][l])
            # x = st((rs[:R] + rs_b[:R]) + x), skip = (skip + rs[R:]) +
            # rs_b[R:] with rs = op(h) rs_w
            x = ordered_res_skip(op(h), params["rs_w"][l], params["rs_b"][l],
                                 x.reshape(-1, R), skip,
                                 round_x=prec == "bf16").reshape(T, B, R)
        if return_xt:
            xt.append(x)
        skip = torch.clamp_min(skip, 0.0)
        zs = torch.clamp_min(_mm(op(skip), params["out_w"])
                             + params["out_b"], 0.0)
        za = _mm(op(zs), params["end_w"]) + params["end_b"]
        p_seq = em.softmax_canonical(za).reshape(T, B, A)
        y_state.copy_(y_full[nv:nv + 2])
        out = (p_seq, ring, y_state)
        if return_xt:
            out += (torch.stack(xt),)                     # [L+1, T, B, R]
        if return_za:
            out += (za.reshape(T, B, A),)
        return out

    return score


def make_state_committer(cfg: WaveNetConfig):
    """Build `commit(ring, xt, y, y_state, t0, nv)` -> (ring, y_state): the
    carried state after committing the first nv steps of a window the scorer
    already evaluated, from its `return_xt` activations, without a second
    scorer pass.  Position j's activations depend only on symbols emitted
    before j, so xt[l][:nv] of a drafted window whose symbols before nv - 1
    are right is the exact trajectory's, and the state equals a scorer pass
    over the corrected window with n_valid=nv.

    ring: the pre-window ring (updated in place); xt: [>= L, T, B, R]; y:
    [T, B] the corrected window symbols; y_state: [2, B] pre-window (updated
    in place); t0 the window's first step; nv in [1, T]."""
    dils, offs = cfg.dilations, cfg.ring_offsets

    def commit(ring: torch.Tensor, xt: torch.Tensor, y: torch.Tensor,
               y_state: torch.Tensor, t0, nv):
        t0, nv = int(t0), int(nv)
        for l, (d, off) in enumerate(zip(dils, offs)):
            x_full = torch.cat([_history(ring, off, d, t0),
                                xt[l].to(ring.dtype)], 0)
            _write_back(ring, off, d, x_full, t0 + nv, nv)
        y_full = torch.cat([y_state, y.to(torch.int32)], 0)
        y_state.copy_(y_full[nv:nv + 2])
        return ring, y_state

    return commit


def bits_per_sample(p_seq: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Teacher-forced negative log2-likelihood per step: p_seq [T, B, A]
    (from `make_parallel_scorer`), y [T, B] int -> [T, B] bits.  The mean
    over (T, B) is the bits-per-sample metric."""
    p = torch.gather(p_seq, -1, y[..., None].long())[..., 0]
    return -torch.log2(torch.clamp_min(p, 1e-30))
