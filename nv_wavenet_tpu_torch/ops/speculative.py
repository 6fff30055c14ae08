"""Speculative exact decode: the exact kernel's samples, drafted by the
collapsed-chain kernel K6 and verified by the time-parallel scorer.

The port's counterpart of `nv_wavenet_tpu/ops/speculative.py`.  With
injected selectors sampling is deterministic: step t emits
y*_t = select(p_t, sel_t) with p_t the exact fp32 distribution.  So a round

  1. DRAFTS K steps with K6 (fast_math, raw conditioning) on a copy of the
     state, from the same selectors;
  2. VERIFIES them in one pass of the exact scorer (`ops/score_parallel.py`,
     kernels K7, K0a, K0c): teacher-forcing the drafted symbols gives every
     step's exact logits, and `select_window` (K0b) the exact choices;
  3. COMMITS the longest prefix where draft and exact agree plus the first
     exact choice after it (positions up to the first disagreement had
     exact inputs, so that choice is the exact kernel's): the verify pass's
     own state when the whole window agrees, else the state committer
     (`score_parallel.make_state_committer`) at that length.

The output equals the exact kernel's bit for bit for every selector stream;
the draft decides only how many rounds it takes.  The JAX package runs the
rounds in one on-device `lax.while_loop`; here they are a loop on the host,
and each round reads one int32 back, the first disagreement: a
synchronisation per round that belongs to the round's fixed cost V0.  The
JAX loop pads cond and sel by K so its last round keeps the window's
shape; eagerly the last round drafts and verifies only the steps left,
which commits the same samples and state.

The whole batch commits in lockstep at the first disagreement of any row,
so the gain, where there is one, shrinks with batch.  `make_adaptive_
generator` lets a short probe measure the committed run length and a cost
model pick the fastest of {window, window/2, the exact kernel}: equally
exact branches, so the choice moves speed only.

`DEFAULT_COST` = (V0_us, V1_us, E0_us), a round costing ~V0 + V1 K and an
exact step E0, measured on an NVIDIA H100 80GB HBM3 at 700 W (power limit
from nvidia-smi) at the flagship (20 layers, R=64, S=256, A=256,
max_dilation 512), b=1: V0 and V1 a least-squares fit of the round time
at K = 64, 128, 256, E0 the exact kernel K1's time per step (chip_smoke.py,
the cost-fit phase).  The JAX package's (145.0, 7.34, 8.66) are TPU v5e
numbers and are not used.  At the flagship V1 (K6's step plus the verify's
share) exceeds E0, so the adaptive tier picks the exact kernel for every
probe result there.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.ops import exact_math as em
from nv_wavenet_tpu_torch.ops import fused_chain, score_parallel

# (V0_us, V1_us, E0_us): see the module docstring; NVIDIA H100 80GB HBM3,
# 700 W, chip_smoke.py phase 32, with the scorer on K7's fused gate and
# res/skip entries (the verify of a round is one scorer pass, with the
# commit and the read-back V0), V1 the cluster K6's drafted step
# (csrc/fused_chain.cu, b=1, fast_math) and E0 the staged K1's step
# (csrc/staged_generate.cu, its flagship-width instance); each window's
# round the mean of three runs (a single run's fit moved V0 by ~300 us)
DEFAULT_COST = (1138.2, 83.59, 53.13)

BRANCHES = {0: "window", 1: "window/2", 2: "exact", -1: "too short to probe"}


def select_window(za_seq: torch.Tensor, sel: torch.Tensor,
                  silence_bin: int) -> torch.Tensor:
    """The exact choices of a window: za_seq [T, B, A] logits, sel [T, B]
    -> y [T, B] int32, through the one canonical sampler
    (`exact_math.sample_from_logits`: K0b on the card, the plain version on
    the CPU), row by row as the generation kernels sample."""
    T, B = sel.shape
    A = za_seq.shape[-1]
    return em.sample_from_logits(
        za_seq.reshape(T * B, A).contiguous(),
        sel.reshape(T * B, 1).contiguous(), silence_bin).reshape(T, B)


def make_speculative_generator(cfg: WaveNetConfig, batch: int, window: int):
    """Build `generate(params, folded, t0, cond, sel, ring, y_state)` ->
    (y [T, B] int32, ring, y_state, rounds).

    params: the canonical float32 values the exact path computes with (the
    engine's `persistent.value_view`), for the verify pass; folded: the
    draft's operands, `fused_chain.prepare_weights(params, cfg,
    prefold_cond=False, fast_math=True)`, made once per weight upload by
    the caller.
    cond [T, L, B, 2R] raw (dil_b not added), sel [T, B] injected
    selectors, ring [ring_size, B, R] float32 and y_state [2, B] int32 as
    the other generators take them, updated in place.  All on one device:
    the card runs K6, K7, K0a, K0c and K0b, the CPU their plain versions.
    `window` = K, the steps drafted a round; `rounds` is how many rounds
    were taken (T / rounds is the mean committed run).

    y equals the exact kernel's sample-mode output for the same inputs and
    ring / y_state its carried state, so chunked calls compose."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    K, B = window, batch
    draft = fused_chain.make_fused_generator(cfg, B, mode="sample",
                                             fast_math=True,
                                             prefold_cond=False)
    scorer = score_parallel.make_parallel_scorer(
        cfg, B, prefold_cond=False, return_xt=True, return_za=True)
    commit = score_parallel.make_state_committer(cfg)

    def generate(params: Dict[str, torch.Tensor], folded: tuple, t0,
                 cond: torch.Tensor, sel: torch.Tensor, ring: torch.Tensor,
                 y_state: torch.Tensor):
        T = cond.shape[0]
        t0 = int(t0)
        dev = cond.device
        ring_in, ys_in = ring, y_state
        y = torch.empty((T, B), dtype=torch.int32, device=dev)
        # the draft's scratch state, and the verify pass's (which becomes
        # the state when the whole window commits)
        ring_d, ys_d = torch.empty_like(ring), torch.empty_like(y_state)
        ring_v, ys_v = torch.empty_like(ring), torch.empty_like(y_state)
        n_out, rounds = 0, 0
        while n_out < T:
            n = min(K, T - n_out)
            t = t0 + n_out
            cond_k = cond[n_out:n_out + n].contiguous()
            sel_k = sel[n_out:n_out + n].contiguous()
            ring_d.copy_(ring)
            ys_d.copy_(y_state)
            y_d = draft(folded, t, cond_k, sel_k, ring_d, ys_d)[0]
            ring_v.copy_(ring)
            ys_v.copy_(y_state)
            xt, za = scorer(params, t, cond_k, y_d, ring_v, ys_v)[3:]
            y_ex = select_window(za, sel_k, cfg.silence_bin)
            dis = (y_d != y_ex).any(dim=1)
            steps = torch.arange(n, dtype=torch.int32, device=dev)
            # the round's one read-back: the first disagreement, n if none
            first = int(torch.where(dis, steps, n).min())
            n_emit = min(first + 1, n)
            y[n_out:n_out + n_emit] = y_ex[:n_emit]
            if first == n:
                # the whole window agreed: the verify pass's state is the
                # exact trajectory's after n steps
                ring, ring_v = ring_v, ring
                y_state, ys_v = ys_v, y_state
            else:
                commit(ring, xt, y_ex, y_state, t, n_emit)
            n_out += n_emit
            rounds += 1
        if ring is not ring_in:
            ring_in.copy_(ring)
            ys_in.copy_(y_state)
        return y, ring_in, ys_in, rounds

    return generate


def expected_commit(K, r):
    """E[samples committed a round] at window K when draft-vs-exact flips
    are ~iid with mean run length r (geometric): r (1 - e^{-K/r}), as
    r * -expm1(-K/r) in float32, the JAX package's arithmetic."""
    r = np.maximum(np.float32(r), np.float32(1.0))
    return np.float32(r * -np.expm1(-np.float32(K) / r))


def invert_commit(K, c):
    """The mean run length r from a measured commits-per-round c at window
    K (the inverse of `expected_commit`, three fixed-point sweeps, float32);
    a saturated c (>= 0.95 K: the draft never missed) maps to 1e9."""
    c = np.maximum(np.minimum(np.float32(c),
                              np.float32(K) * np.float32(0.999)),
                   np.float32(1.0))
    r = c
    for _ in range(3):
        r = np.float32(c / -np.expm1(
            -np.float32(K) / np.maximum(r, np.float32(1e-3))))
    return np.float32(1e9) if c >= np.float32(0.95 * K) else r


def choose_branch(window: int, probe_window: int, probe_steps: int,
                  probe_rounds: int, cost=DEFAULT_COST) -> int:
    """The adaptive tier's pick from a probe of `probe_steps` steps at
    window `probe_window` that took `probe_rounds` rounds: the largest of
    the rates expected_commit(K) / (V0 + V1 K) at K = window, window / 2
    and 1 / E0 (0, 1, 2; the first on a tie), in float32."""
    V0, V1, E0 = (np.float32(v) for v in cost)
    commits = np.float32(probe_steps) / np.float32(max(probe_rounds, 1))
    r_hat = invert_commit(probe_window, commits)
    rates = [expected_commit(k, r_hat) / (V0 + V1 * np.float32(k))
             for k in (window, max(window // 2, 1))]
    rates.append(np.float32(1.0) / E0)
    return int(np.argmax(np.asarray(rates, np.float32)))


def make_adaptive_generator(cfg: WaveNetConfig, batch: int, window: int,
                            exact: Callable, probe_window: int = 64,
                            cost=DEFAULT_COST):
    """The self-governing tier: build `generate(params, folded, t0, cond,
    sel, ring, y_state)` -> (y [T, B], ring, y_state, rounds, branch).

    A probe of 4 * min(probe_window, window) steps at window
    min(probe_window, window) measures the committed run length;
    `choose_branch` turns it into the branch that runs the rest: 0 the
    speculative tier at `window`, 1 at window / 2, 2 `exact`; -1 when
    T <= probe + window, too short to probe (the fixed tier at `window`
    runs it all).  Every branch emits the exact kernel's samples, the
    probe's included.

    `exact(t0, cond, sel, ring, y_state) -> y`, from raw cond, updating the
    state in place, is the exact branch (the engine passes `run()`'s own
    dispatch: K1, or K4 under MANYBLOCK).  Arguments otherwise as
    `make_speculative_generator`'s."""
    K, B = window, batch
    Kp = min(probe_window, K)
    Tp = 4 * Kp
    spec_full = make_speculative_generator(cfg, B, K)
    spec_half = make_speculative_generator(cfg, B, max(K // 2, 1))
    spec_probe = (make_speculative_generator(cfg, B, Kp) if Kp != K
                  else spec_full)

    def generate(params: Dict[str, torch.Tensor], folded: tuple, t0,
                 cond: torch.Tensor, sel: torch.Tensor, ring: torch.Tensor,
                 y_state: torch.Tensor):
        T = cond.shape[0]
        t0 = int(t0)
        if T <= Tp + K:
            y, ring, y_state, rounds = spec_full(params, folded, t0, cond,
                                                 sel, ring, y_state)
            return y, ring, y_state, rounds, -1
        y1, ring, y_state, rounds1 = spec_probe(
            params, folded, t0, cond[:Tp], sel[:Tp], ring, y_state)
        branch = choose_branch(K, Kp, Tp, rounds1, cost)
        t1, cond2, sel2 = t0 + Tp, cond[Tp:], sel[Tp:]
        rounds2 = 0
        if branch == 2:
            y2 = exact(t1, cond2, sel2, ring, y_state)
        else:
            spec = spec_full if branch == 0 else spec_half
            y2, ring, y_state, rounds2 = spec(params, folded, t1, cond2,
                                              sel2, ring, y_state)
        return (torch.cat([y1, y2]), ring, y_state, rounds1 + rounds2,
                branch)

    return generate
