"""The H100 cost model: the port's counterpart of
`nv_wavenet_tpu/utils/profiling.py` (tracing is `utils/tracing.py`).

  * `step_cost(cfg)`: the analytic count per sample (FLOPs, weight and
    conditioning bytes, the dependent products of a step), the same count
    as the JAX package's, with the H100's roofline and latency floors;
  * `memory_report(cfg, batch, chunk)`: weights, FIFO ring and cond stream,
    and the shared memory per CTA and L2 footprint of K1, K4 and K6 against
    the card's 227 KB and 50 MB (the JAX package's VMEM report).

Every constant here is the H100's, never the TPU's: the peaks from NVIDIA's
data sheet for the H100 SXM, `STAGE_NS` measured by probe P5
(`tools/probe_stage.py`, its fastest layout) on the card named beside it.  The JAX package's
`stage_ns=200` and its 128-lane K-tile model are TPU v5e figures.
"""

from __future__ import annotations

import dataclasses
import subprocess

import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.ops import fused_chain, persistent

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 1024 * 1024
# ns per dependent stage, x -> x W [16, 64] @ [64, 128] -> gate: probe P5
# exact, B=16, D=43, the least over its layouts (tools/probe_stage.py
# floor_labels): layout "stream", W_d staged by TMA through a ring, one CTA
# per row (K1's layout); NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
# phase 30, T=1024, W laid out before the timed launches; the first design,
# W read from L2 inside the chain, took 3226.2 in the same run)
STAGE_NS = 447.0


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (`--query-gpu=name,power.limit`), for a line beside every number."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


@dataclasses.dataclass(frozen=True)
class StepCost:
    flops_per_sample_per_utt: float
    weight_bytes: int
    cond_bytes_per_sample_per_utt: int
    critical_path_matmuls: int

    def roofline_khz(self, batch: int, peak_flops: float = PEAK_FP32_FLOPS,
                     hbm_bytes_per_s: float = HBM_BYTES_PER_S) -> float:
        """Upper bound on kHz per utterance on an H100: a step of `batch`
        rows does batch * FLOPs at the fp32 peak and reads the weights once
        and each row's conditioning at the HBM rate; the slower of the two
        bounds it."""
        compute = peak_flops / (self.flops_per_sample_per_utt * batch)
        memory = hbm_bytes_per_s / (self.weight_bytes
                                    + self.cond_bytes_per_sample_per_utt
                                    * batch)
        return min(compute, memory) / 1e3

    def latency_floor_khz(self, stage_ns: float = STAGE_NS) -> float:
        """The binding bound of this workload: a sample is a chain of
        `critical_path_matmuls` dependent products (embed, L x (dilated,
        residual), Zs, Za), each at least one stage of probe P5 (default:
        STAGE_NS, the exact stage in the "stream" layout, W staged by TMA
        into one CTA per row as K1 stages its weights, measured on the
        H100).  Batch does not move it: one CTA runs each row."""
        return 1e6 / (self.critical_path_matmuls * stage_ns)

    def fused_latency_floor_khz(self, cfg: WaveNetConfig,
                                stage_ns: float = STAGE_NS,
                                pack_gates: bool = False) -> float:
        """The latency floor of the first K6's collapsed chain
        (`ops/fused_chain.py`, one CTA a row): embed, w0, L gated stages,
        skip, Zs, Za = L+5 stages, where layer
        l's stage also contracts over its l * P earlier gate outputs
        (P = R packed, else max(R, 128)).  K6 splits a product's terms over
        `fused_chain._splits(2R)` thread sets, so a thread sums
        l * P / splits of them: every R of those beyond the first costs one
        more stage (a stage of P5 sums R terms)."""
        L, R = cfg.num_layers, cfg.R
        P = fused_chain._row_stride(R, pack_gates)
        s = fused_chain._splits(2 * R)
        extra = sum(max(0, -(-l * P // (s * R)) - 1) for l in range(L))
        return 1e6 / ((L + 5 + extra) * stage_ns)


def step_cost(cfg: WaveNetConfig) -> StepCost:
    """FLOPs, bytes and the dependent chain of one sample of one utterance,
    the JAX package's count."""
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    flops = 2.0 * (2 * A * R              # embedding one-hot GEMM
                   + L * (2 * R * 2 * R)  # dilated conv
                   + L * (R * (R + S))    # residual+skip
                   + S * A + A * A)       # output stack
    return StepCost(flops_per_sample_per_utt=flops,
                    weight_bytes=cfg.weight_bytes(4),
                    cond_bytes_per_sample_per_utt=L * 2 * R * 4,
                    critical_path_matmuls=2 * L + 3)


def memory_report(cfg: WaveNetConfig, batch: int, chunk: int,
                  weight_dtype=torch.float32) -> str:
    """Where a dispatch's bytes live on an H100: the weights, the FIFO ring
    and one launch's cond chunk, and for K1, K4 (fp32 stacks, or bf16
    under weight_dtype=torch.bfloat16) and K6 the shared memory a CTA asks
    for against a block's 227 KB and what the launch keeps in L2 against
    its 50 MB (a kernel that cannot run at this geometry says why)."""
    mb, kb = 1024 * 1024, 1024
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    weights = cfg.weight_bytes(4)
    ring = cfg.ring_bytes(batch)
    cond = chunk * L * batch * 2 * R * 4
    block = persistent.SMEM_PER_BLOCK
    lines = [
        f"Memory plan for L={L} R={R} S={S} A={A} maxD={cfg.max_dilation} "
        f"B={batch} chunk={chunk} on an H100 ({block // kb} KB of shared "
        f"memory a block, {L2_BYTES // mb} MB of L2):",
        f"  weights      {weights / mb:8.2f} MB (fp32 canonical)",
        f"  ring buffer  {ring / mb:8.2f} MB ({cfg.ring_size} FIFO slots x "
        f"{batch} rows x {R}, fp32)",
        f"  cond stream  {cond / mb:8.2f} MB (one launch's [{chunk}, {L}, "
        f"{batch}, {2 * R}] fp32)"]

    def row(name, smem, l2, note=""):
        lines.append(f"  {name:3s} shared memory {smem / kb:7.1f} KB of "
                     f"{block / kb:.0f} per CTA; L2 {l2 / mb:7.2f} MB of "
                     f"{L2_BYTES // mb}{note}")

    row("K1", persistent.activation_smem_bytes(cfg), weights + ring + cond)
    try:
        plan = persistent.stream_plan(cfg, batch, weight_dtype)
        eb = torch.empty((), dtype=plan.storage).element_size()
        stacks = L * (2 * R * 2 * R + R * (R + S))
        row("K4", plan.smem_bytes,
            weights - stacks * (4 - eb) + ring + cond,
            f" ({plan.stages} stages of {plan.rows_per_stage} rows, "
            f"{plan.waves} wave(s))")
    except ValueError as err:
        lines.append(f"  K4  cannot run: {err}")
    try:
        route = fused_chain.fused_route(cfg, batch)
        folded = sum(4 * torch.Size(s).numel()
                     for s in fused_chain.folded_shapes(cfg).values())
        note = (f" (folded weights {folded / mb:.2f} MB; a cluster of "
                f"{route.plan.cluster} CTAs a group of {route.plan.rows} "
                f"row(s))" if route.kernel == "cluster" else
                f" (folded weights {folded / mb:.2f} MB; the first K6)")
        row("K6", route.plan.smem_bytes, folded + ring + cond, note)
    except ValueError as err:
        lines.append(f"  K6  cannot run: {err}")
    return "\n".join(lines)
