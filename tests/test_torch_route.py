"""The route of a generation call and the staged K4, on the CPU
(`ops/persistent.py::generation_route`, `staged_plan` with a storage dtype,
`staged_stream`; the kernels, `csrc/generic_generate.cu` and
`csrc/staged_generate.cu`, run only on the card).

* The route names the generic K1/K5 where the staged plan raises (fault F2
  of ROADMAP.md: A = 2048, R = 512, an odd R under bf16), the staged K1/K5
  at every geometry of `PLAN_CONFIGS`, the staged K4 wherever its plan
  holds the storage, and the first K4 at A = 2048 and, its general
  instance, at R = 512 and an odd R in bf16 (fault F3: MANYBLOCK engines
  there equal the JAX K4 and the bf16 engine); modes forced and prng take
  the staged K4 on K1's own stream wherever the staged plan holds, else the
  first K4 in the precision's storage (every F2 and F3 geometry, where the
  engine builds them), else the generic kernel, and the engine holds one
  copy of that stream.  The engine notes a fallback once.
* The staged K4's plan sizes its slots by the storage's bytes, fits the
  block, and its fixed-width instances carry the plan's numbers; the
  thread-to-column map is a bijection in every storage.
* The stream un-lays to the storage's values: int8 q with their scales,
  bf16, fp32, and out_w / end_w as the value view holds them.
* A plain model of the staged K4 (the kernel's arithmetic on the stream's
  bytes: q dequantised by one rounded product q * s, bf16 widened, every
  column summed quad by quad in k order) equals the same model fed the
  value view's stacks bit for bit, `generate_plain` on `value_view` in y
  and y_state, and the JAX package's K4 with stream_weights=True,
  stream_quant=True in interpret mode (0 integer mismatches).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nv_wavenet_tpu.models import params as params_lib
from nv_wavenet_tpu.ops import exact_math as jem
from nv_wavenet_tpu_torch import config as tcfg
from nv_wavenet_tpu_torch.engine.wavenet_infer import Impl, WaveNetInfer
from nv_wavenet_tpu_torch.models import params as tparams
from nv_wavenet_tpu_torch.ops import exact_math as em
from nv_wavenet_tpu_torch.ops import persistent as tper
from nv_wavenet_tpu_torch.ops import scan_generate as tsg
from nv_wavenet_tpu_torch.utils import build as tbuild

from nv_wavenet_tpu.config import WaveNetConfig as JaxConfig
from tests.test_golden_vs_scan import make_case
from tests.test_streaming_kernel import CONFIGS as STREAM_CONFIGS, run_stream
from tests.test_torch_persistent import port_cfg
from tests.test_torch_staged import (BLOCK, PLAN_CONFIGS, _inputs, _params,
                                     _RowProducts, model_run)

STORAGES = {"fp32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}
STORAGE_KW = {"fp32": {}, "bf16": {"weight_dtype": torch.bfloat16},
              "int8": {"stream_quant": True}}
# (storage, precision) pairs K4 has (`stream_storage`)
K4_CASES = [("fp32", "exact"), ("bf16", "exact"), ("int8", "exact"),
            ("bf16", "fast"), ("int8", "fast"), ("bf16", "bf16"),
            ("int8", "bf16")]
# the geometries the staged plan rejects (F2), with the precision
F2_CASES = [
    (tcfg.WaveNetConfig(num_layers=20, R=64, S=256, A=2048,
                        max_dilation=512), "exact", "output columns"),
    (tcfg.WaveNetConfig(num_layers=2, R=512, S=256, A=256, max_dilation=2),
     "exact", "Wprev"),
    (tcfg.WaveNetConfig(num_layers=2, R=9, S=16, A=32, max_dilation=2,
                        silence_bin=16), "bf16", "even"),
]
MODEL_CFG = tcfg.WaveNetConfig(num_layers=3, R=12, S=20, A=32,
                               max_dilation=2, silence_bin=16)


def jax_config(cfg):
    return JaxConfig(num_layers=cfg.num_layers, R=cfg.R, S=cfg.S, A=cfg.A,
                     max_dilation=cfg.max_dilation, tanh_embed=cfg.tanh_embed)


# ----------------------------------------------------------------------
# the route
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cfg,prec,why", F2_CASES)
def test_route_takes_the_generic_kernel_where_the_staged_plan_raises(
        cfg, prec, why):
    with pytest.raises(ValueError, match=why):
        tper.staged_plan(cfg, 4, prec)
    # lockstep exact generation without a dump runs K1 card-wide where its
    # plan holds (R = 512); K5, the dumps and the low precisions stay generic
    try:
        wide = tper.wide_plan(cfg, 4, prec)
    except ValueError:
        wide = None
    assert (wide is not None) == (why == "Wprev")
    for ragged in (False, True):
        route = tper.generation_route(cfg, 4, prec, "sample", ragged)
        assert why in route.note
        if wide is not None and not ragged:
            assert route.kernel == "wide" and route.plan == wide
            assert route.cuda_kernel(prec) is tper.WIDE_KERNELS[prec]
            route = tper.generation_route(cfg, 4, prec, "sample", dump=True)
        assert route.kernel == "generic" and route.plan is None
        kernel = route.cuda_kernel(prec)
        table = (tper.GENERIC_RAGGED_KERNELS if ragged
                 else tper.GENERIC_KERNELS)
        assert kernel is table[prec]
        assert kernel.source == tbuild.unit("generic_generate.cu", prec)
    assert tper.generation_route(cfg, 4, prec, "argmax").kernel == (
        "generic" if wide is None else "wide")
    assert tper.generation_route(cfg, 4, prec, "argmax",
                                 dump=True).kernel == "generic"
    # modes forced and prng take the first K4 in the precision's storage,
    # with the staged plan's error as the note
    for mode in ("forced", "prng"):
        route = tper.generation_route(cfg, 4, prec, mode)
        assert route.kernel == "stream" and why in route.note
        assert route.plan == tper.stream_plan(
            cfg, 4, tper.staged_storage(prec), prec=prec)
        assert route.cuda_kernel(prec) is tper.STREAM_KERNELS[prec]


@pytest.mark.parametrize("prec", tsg.PRECISIONS)
@pytest.mark.parametrize("cfg,batch", PLAN_CONFIGS)
def test_route_takes_the_staged_kernels_where_their_plans_hold(cfg, batch,
                                                               prec):
    for ragged in (False, True):
        route = tper.generation_route(cfg, batch, prec, "sample", ragged)
        assert route.kernel == "staged" and route.note is None
        assert route.plan == tper.staged_plan(cfg, batch, prec)
        assert route.cuda_kernel(prec) is (
            tper.RAGGED_KERNELS if ragged else tper.PERSISTENT_KERNELS)[prec]
    for name, storage in STORAGES.items():
        if prec != "exact" and name == "fp32":
            continue
        route = tper.generation_route(cfg, batch, prec, "forced",
                                      stream_weights=True, storage=storage)
        assert route.kernel == "staged_stream", (name, route.note)
        assert route.plan.storage == storage
        assert route.cuda_kernel(prec) is tper.PERSISTENT_KERNELS[prec]


@pytest.mark.parametrize("prec", tsg.PRECISIONS)
@pytest.mark.parametrize("cfg,batch", PLAN_CONFIGS)
def test_forced_and_prng_take_the_staged_step_where_its_plan_holds(
        cfg, batch, prec):
    """K2 and K3 without stream_weights: the staged K4 on K1's own stream,
    the precision's storage (fp32 exact, bf16 otherwise), with K1's plan."""
    k1 = tper.staged_plan(cfg, batch, prec)
    for mode in ("forced", "prng"):
        route = tper.generation_route(cfg, batch, prec, mode)
        assert route.kernel == "staged_stream" and route.note is None
        assert route.plan == k1
        assert route.plan.storage == tper.staged_storage(prec)
        assert route.cuda_kernel(prec) is tper.PERSISTENT_KERNELS[prec]


# geometries where the staged plan and the first K4's raise: two stages (a
# row of Wprev and Wcur, or of rs_w) do not fit beside the activations
GENERIC_ONLY = [(4096, 16, 256), (1, 16384, 256), (64, 1024, 13800)]


@pytest.mark.parametrize("mode", ["forced", "prng"])
@pytest.mark.parametrize("R,S,A", GENERIC_ONLY)
def test_forced_and_prng_take_the_generic_kernel_where_the_first_k4_cannot(
        R, S, A, mode):
    """The generic kernel holds every geometry whose (7R + S + 4A) floats
    fit the block; where the first K4 raises too, K2/K3 run it, so no
    geometry the port ran before raises."""
    cfg = tcfg.WaveNetConfig(num_layers=2, R=R, S=S, A=A, max_dilation=2)
    with pytest.raises(ValueError):
        tper.staged_plan(cfg, 4)
    with pytest.raises(ValueError, match="two stages"):
        tper.stream_plan(cfg, 4, tper.staged_storage("exact"))
    assert (tper.activation_smem_bytes(cfg) + tper._STATIC_SMEM
            <= tper.SMEM_PER_BLOCK)
    route = tper.generation_route(cfg, 4, "exact", mode)
    assert route.kernel == "generic" and route.plan is None and route.note
    assert route.cuda_kernel() is tper.GENERIC_KERNELS["exact"]


def _staged_plan_raises(cfg, prec):
    try:
        tper.staged_plan(cfg, 2, prec)
    except ValueError:
        return True
    return False


# every F2 geometry (F3's are among them) with each precision in which the
# staged plan raises there
F2_PRECISIONS = [(case, prec) for case in range(len(F2_CASES))
                 for prec in tsg.PRECISIONS
                 if _staged_plan_raises(F2_CASES[case][0], prec)]
_PREC_KW = {"exact": {}, "fast": {"fast_math": True},
            "bf16": {"compute_dtype": torch.bfloat16}}


@pytest.mark.parametrize("case,prec", F2_PRECISIONS)
def test_forced_and_prng_take_the_first_k4_where_the_staged_plan_raises(
        case, prec):
    """Where the staged plan raises at an F2 or F3 geometry, modes forced
    and prng name the first K4 (its general instance where it needs one)
    in the precision's own storage (fp32 exact, bf16 otherwise), with the
    staged plan's error as the note, and the engine builds both
    generators there.  On the CPU they run the plain loop: their values
    are the card's check (chip_smoke.py)."""
    cfg, _, why = F2_CASES[case]
    storage = tper.staged_storage(prec)
    plan = tper.stream_plan(cfg, 2, storage, prec=prec)
    assert plan.storage == storage
    assert plan.smem_bytes + tper._STATIC_SMEM <= BLOCK
    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=2, chunk_size=4, device="cpu",
                       **_PREC_KW[prec])
    for mode in ("forced", "prng"):
        route = tper.generation_route(cfg, 2, prec, mode)
        assert route.kernel == "stream" and why in route.note
        assert route.plan == plan
        assert route.cuda_kernel(prec) is tper.STREAM_KERNELS[prec]
        gen = eng._generator(2, mode)[0]
        assert gen.route.kernel == "stream" and gen.route.plan == plan


def test_route_takes_the_first_k4_where_the_staged_plan_raises():
    cfg = F2_CASES[0][0]   # A = 2048: the first K4's plan holds it
    for name, storage in STORAGES.items():
        route = tper.generation_route(cfg, 16, "exact", "sample",
                                      stream_weights=True, storage=storage)
        assert route.kernel == "stream" and "output columns" in route.note
        assert route.plan == tper.stream_plan(cfg, 16, storage)
        assert route.cuda_kernel() is tper.STREAM_KERNELS["exact"]
    # R = 512, and R = 9 in bf16 (fault F3 of ROADMAP.md, closed): the first
    # K4's general instance, with the staged plan's error as the note
    route = tper.generation_route(F2_CASES[1][0], 2, stream_weights=True)
    assert route.kernel == "stream" and "Wprev" in route.note
    assert route.plan.general
    route = tper.generation_route(F2_CASES[2][0], 2, "bf16",
                                  stream_weights=True, storage=torch.bfloat16)
    assert route.kernel == "stream" and "even" in route.note
    assert route.plan.general
    # an odd R in exact: the staged K4 holds it
    assert tper.generation_route(F2_CASES[2][0], 2, stream_weights=True,
                                 storage=torch.int8).kernel == "staged_stream"
    with pytest.raises(ValueError, match="stream_group_size"):
        tper.generation_route(tcfg.FLAGSHIP_CONFIG, 16, stream_weights=True,
                              stream_group_size=0)


# the F3 geometries (ROADMAP.md): R = 512 in every storage and precision the
# JAX package runs there, R = 9 in bf16 with bf16 and int8 stacks
F3_CASES = [(1, "exact", "fp32"), (1, "exact", "bf16"), (1, "exact", "int8"),
            (1, "fast", "bf16"), (1, "fast", "int8"), (1, "bf16", "bf16"),
            (1, "bf16", "int8"), (2, "bf16", "bf16"), (2, "bf16", "int8")]


@pytest.mark.parametrize("case,prec,name", F3_CASES)
def test_route_takes_the_first_k4_at_the_f3_geometries(case, prec, name):
    """F3: the first K4's plan holds R = 512 (4R past STREAM_MAX_COLUMNS:
    its columns loop) and an odd R in bf16 (rows padded to 16 bytes), and
    the route names it with the staged plan's error as its note."""
    cfg, _, why = F2_CASES[case]
    storage = STORAGES[name]
    with pytest.raises(ValueError, match=why):
        tper.staged_plan(cfg, 2, prec, storage)
    plan = tper.stream_plan(cfg, 2, storage, prec=prec)
    R, S = cfg.R, cfg.S
    eb = storage.itemsize
    assert plan.general
    assert plan.dil_stride >= 2 * R and plan.dil_stride * eb % 16 == 0
    assert plan.rs_stride >= R + S and plan.rs_stride * eb % 16 == 0
    assert plan.dil_stride * eb - 2 * R * eb < 16
    assert plan.rs_stride * eb - (R + S) * eb < 16
    assert plan.stage_bytes >= plan.rows_per_stage * max(
        2 * plan.dil_stride, plan.rs_stride) * eb
    assert plan.smem_bytes + tper._STATIC_SMEM <= BLOCK
    assert plan.smem_bytes >= (plan.stages * plan.stage_bytes
                               + tper.activation_smem_bytes(cfg, prec, True))
    for mode in tsg.MODES:
        route = tper.generation_route(cfg, 2, prec, mode, stream_weights=True,
                                      storage=storage)
        assert route.kernel == "stream" and why in route.note
        assert route.plan == plan
        assert route.cuda_kernel(prec) is tper.STREAM_KERNELS[prec]


def test_first_k4_stacks_pad_rows_with_zeros():
    """The general instance's stored rows: the storage's values, then zeros
    up to the stride (read by no sum)."""
    cfg = F2_CASES[2][0]   # R = 9, S = 16: rows of 18 and 25 elements
    params = _params(cfg, seed=4)
    for name in ("bf16", "int8"):
        plan = tper.stream_plan(cfg, 2, STORAGES[name], prec="bf16")
        view = tsg.product_view(params, "bf16")
        dil, rs, sd, sr = tper._stream_stacks(
            params if name == "int8" else view, plan)
        assert dil.shape == (2, 18, plan.dil_stride) and dil.is_contiguous()
        assert rs.shape == (2, 9, plan.rs_stride) and rs.is_contiguous()
        assert not dil[..., 18:].any() and not rs[..., 25:].any()
        if name == "int8":
            qd, sd2, qr, sr2 = tper.quantize_stream_weights(params)
            assert torch.equal(dil[..., :18], qd) and torch.equal(sd, sd2)
            assert torch.equal(rs[..., :25], qr) and torch.equal(sr, sr2)
        else:
            assert torch.equal(dil[..., :18].float(), view["dil_w"])
            assert torch.equal(rs[..., :25].float(), view["rs_w"])


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_f3_manyblock_engine_at_r512_equals_the_jax_k4(quant):
    """F3: WaveNetInfer(implementation=Impl.MANYBLOCK) constructs at R = 512
    and generates what the JAX package's K4 (stream_weights=True, in
    interpret mode) generates: 0 integer mismatches."""
    cfg = F2_CASES[1][0]
    jcfg = jax_config(cfg)
    B, T = 1, 4
    ref_w, cond, sel = make_case(jcfg, B, T, seed=31)
    params_np = params_lib.to_canonical(ref_w, jcfg)
    y_j, _, ys_j = run_stream(jcfg, {k: jnp.asarray(v)
                                     for k, v in params_np.items()},
                              cond, sel, B, T, stream_quant=quant)
    eng = WaveNetInfer(num_layers=2, max_dilation=2, R=512, S=256, A=256,
                       max_batch=B, chunk_size=T, device="cpu",
                       implementation=Impl.MANYBLOCK,
                       stream_quant="int8" if quant else None)
    assert eng._generator(B, "sample")[0].route.kernel == "stream"
    eng.set_reference_weights(ref_w)
    eng.set_inputs(cond, sel)
    y = eng.run(T, B)
    assert int((y != y_j).sum()) == 0
    assert np.array_equal(eng.export_state()["y_state"], np.asarray(ys_j))


def test_f3_manyblock_engine_at_odd_r_in_bf16_equals_the_bf16_engine():
    """F3: MANYBLOCK at R = 9 under compute_dtype=torch.bfloat16 with bf16
    stacks constructs, and generates what the port's default bf16 engine
    fed the same (bf16-rounded) values generates: 0 integer mismatches."""
    kw = dict(num_layers=2, max_dilation=2, R=9, S=16, A=256, max_batch=2,
              chunk_size=4, device="cpu", compute_dtype=torch.bfloat16)
    cfg = tcfg.WaveNetConfig(num_layers=2, R=9, S=16, A=256, max_dilation=2)
    T = 9
    ref_w = tparams.random_reference_weights(cfg, seed=12)
    rounded = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16).float().numpy() for k, v in ref_w.items()}
    rng = np.random.RandomState(8)
    cond = rng.uniform(-0.5, 0.5, (T, 2, 2, 18)).astype(np.float32)
    sel = rng.uniform(0, 1, (T, 2)).astype(np.float32)
    many = WaveNetInfer(**kw, implementation=Impl.MANYBLOCK,
                        weight_dtype=torch.bfloat16)
    assert many._generator(2, "sample")[0].route.kernel == "stream"
    ref = WaveNetInfer(**kw)
    ys = []
    for eng, w in ((many, ref_w), (ref, rounded)):
        eng.set_reference_weights(w)
        eng.set_inputs(cond, sel)
        ys.append(eng.run(T, 2))
    assert int((ys[0] != ys[1]).sum()) == 0


def test_generator_carries_its_route_and_runs_the_plain_version_on_cpu():
    """The generator names its route at construction; on the CPU it runs
    the plain version, launching nothing, on every route."""
    cfg, B, T = F2_CASES[2][0], 2, 4
    params = _params(cfg)
    cond, sel = _inputs(cfg, B, T, 1)
    cond_pre = (cond + params["dil_b"][None, :, None, :]).contiguous()
    tables = (tper.GENERIC_KERNELS, tper.GENERIC_RAGGED_KERNELS,
              tper.PERSISTENT_KERNELS, tper.STREAM_KERNELS)
    before = [t["bf16"].launches for t in tables]
    ring = tper.init_ring(cfg, B, "cpu", torch.bfloat16)
    ys = torch.full((2, B), cfg.silence_bin, dtype=torch.int32)
    gen = tper.make_persistent_generator(cfg, B,
                                         compute_dtype=torch.bfloat16)
    assert gen.route.kernel == "generic"
    y = gen(params, 0, cond_pre, sel, ring, ys)[0]
    ring2 = tper.init_ring(cfg, B, "cpu", torch.bfloat16)
    ys2 = torch.full((2, B), cfg.silence_bin, dtype=torch.int32)
    ref = tper.generate_plain(cfg, tsg.product_view(params, "bf16"), 0,
                              cond_pre, sel, ring2, ys2, T, prec="bf16")
    assert torch.equal(y, ref[0]) and torch.equal(ys, ref[2])
    assert before == [t["bf16"].launches for t in tables]
    gen5 = tper.make_persistent_generator(cfg, B, ragged=True,
                                          compute_dtype=torch.bfloat16)
    assert gen5.route.kernel == "generic" and gen5.route.ragged


def test_engine_notes_a_fallback_route_once(capsys):
    kw = dict(num_layers=2, max_dilation=2, R=64, S=256, A=2048, max_batch=2,
              device="cpu")
    WaveNetInfer(**kw)
    out = capsys.readouterr().out
    assert out.count("note:") == 1 and "generic kernel" in out
    WaveNetInfer(**kw, implementation=Impl.MANYBLOCK, stream_quant="int8")
    out = capsys.readouterr().out
    assert out.count("note:") == 1 and "first K4" in out
    WaveNetInfer(**{**kw, "A": 256})
    assert "note:" not in capsys.readouterr().out


def test_engine_generates_at_an_f2_geometry_on_cpu():
    """The reference generates at A = 2048; the port's engine runs there
    too (the generic kernel on the card, the plain loop here)."""
    cfg = tcfg.WaveNetConfig(num_layers=2, R=16, S=32, A=2048,
                             max_dilation=2)
    B, T = 2, 5
    ref_w = params_lib.random_reference_weights(cfg, seed=3)
    rng = np.random.RandomState(2)
    cond = rng.uniform(-0.5, 0.5, (T, 2, B, 2 * cfg.R)).astype(np.float32)
    sel = rng.uniform(0, 1, (T, B)).astype(np.float32)
    ys = []
    for impl in (Impl.AUTO, Impl.MANYBLOCK):
        eng = WaveNetInfer(num_layers=2, max_dilation=2, R=16, S=32, A=2048,
                           max_batch=B, device="cpu", implementation=impl)
        eng.set_reference_weights(ref_w)
        eng.set_inputs(cond, sel)
        ys.append(eng.run(T, B))
    assert np.array_equal(ys[0], ys[1])
    assert tper.generation_route(cfg, B).kernel == "generic"


# ----------------------------------------------------------------------
# the staged K4's plan and stream
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name,prec", K4_CASES)
@pytest.mark.parametrize("cfg,batch", PLAN_CONFIGS)
def test_k4_plan_sizes_the_ring_by_the_storage_bytes(cfg, batch, name, prec):
    storage = STORAGES[name]
    plan = tper.staged_plan(cfg, batch, prec, storage)
    k1 = tper.staged_plan(cfg, batch, prec)
    assert plan.smem_bytes <= BLOCK
    assert plan.storage == storage
    assert plan.out_storage == (tper.staged_storage(prec) if name == "int8"
                                else storage)
    assert (plan.chain_threads, plan.prev_threads) == (k1.chain_threads,
                                                       k1.prev_threads)
    assert len(plan.kernel_args()) == len(k1.kernel_args())
    assert plan.kernel_args()[7] == storage.itemsize
    for m in plan.matrices:
        eb = (plan.out_storage if m.name in ("out", "end")
              else storage).itemsize
        assert m.row_bytes == m.Np * 4 * eb and m.row_bytes % 16 == 0
        slot = plan.prev_slot_bytes if m.name == "prev" else plan.slot_bytes
        assert m.rows == min(m.kq, slot // m.row_bytes)
        assert (m.chunks - 1) * m.rows < m.kq <= m.chunks * m.rows
        assert m.offset % 16 == 0
    assert plan.layer_bytes == sum(m.kq * m.row_bytes
                                   for m in plan.matrices[:3])
    assert plan.stream_bytes == (cfg.num_layers * plan.layer_bytes + sum(
        m.kq * m.row_bytes for m in plan.matrices[3:]))
    if storage == k1.storage:   # K4 on K1's own stream: K1's plan
        assert plan == k1


def test_k4_plan_raises_for_a_storage_it_lacks():
    with pytest.raises(ValueError, match="fp32"):
        tper.staged_plan(tcfg.FLAGSHIP_CONFIG, 16, "fast", torch.float32)
    with pytest.raises(ValueError, match="fp32"):
        tper.staged_plan(tcfg.FLAGSHIP_CONFIG, 16, "exact", torch.float16)


def _k4_fixed_widths():
    """{(geometry, precision, storage): (R, S, A, Tc, Tp, rows...)} of the
    instances `csrc/staged_generate.cu` compiles for fixed widths, read
    from its `fixed_widths`."""
    with open(os.path.join(tbuild.CSRC_DIR, "staged_generate.cu")) as f:
        src = f.read()
    body = src[src.index("constexpr Fixed fixed_widths("):]
    body = body[:body.index("Fixed{};")]
    found = {}
    for geo, cond, nums in re.findall(
            r"geo == (\d+)((?: && [\w =]+)?)\s*\?\s*Fixed\{([\d, {}]+)\}\}",
            body):
        vals = tuple(int(v) for v in re.findall(r"\d+", nums))
        for name, prec in K4_CASES:
            key = (int(geo), prec, name)
            if key in found:
                continue
            if ("kStorageF32" in cond and name != "fp32"
                    or "kStorageBF16" in cond and name != "bf16"
                    or "kPrecExact" in cond and prec != "exact"):
                continue
            found[key] = vals
    return found


@pytest.mark.parametrize("name,prec", K4_CASES)
@pytest.mark.parametrize("geometry", [1, 2])
def test_k4_fixed_width_instances_match_the_plan(geometry, name, prec):
    R, S, A = tper.STAGED_FIXED_WIDTHS[geometry - 1]
    cfg = tcfg.WaveNetConfig(num_layers=20, R=R, S=S, A=A, max_dilation=8)
    plan = tper.staged_plan(cfg, 16, prec, STORAGES[name])
    assert plan.geometry == geometry
    assert _k4_fixed_widths()[(geometry, prec, name)] == (
        R, S, A, plan.chain_threads, plan.prev_threads,
        *(m.rows for m in plan.matrices))


@pytest.mark.parametrize("name", ["bf16", "int8"])
@pytest.mark.parametrize("cfg,batch", PLAN_CONFIGS[:6])
def test_column_map_is_a_bijection_in_every_storage(cfg, batch, name):
    plan = tper.staged_plan(cfg, batch, "exact", STORAGES[name])
    cols = tper.staged_columns(cfg, plan)
    R, S, A = cfg.R, cfg.S, cfg.A
    for key, n in {"cur": 2 * R, "prev": 2 * R, "rs": R + S,
                   "out": A}.items():
        assert sorted(c for _, c in cols[key]) == list(range(n)), key
        assert np.bincount([t for t, _ in cols[key]]).max() \
            <= tper.STAGED_MAX_COLUMNS


def _k4_stream(params, cfg, B, name, prec):
    """(plan, stream, dil_s, rs_s, view) as the generator builds them."""
    kw = STORAGE_KW[name]
    quant = bool(kw.get("stream_quant"))
    view = tsg.product_view(tper.value_view(
        params, kw.get("weight_dtype", torch.float32), quant), prec)
    storage = tper.stream_storage(kw.get("weight_dtype", torch.float32),
                                  quant, prec)
    plan = tper.generation_route(cfg, B, prec, stream_weights=True,
                                 storage=storage).plan
    if quant:
        qd, sd, qr, sr = tper.quantize_stream_weights(params)
        stream = tper.staged_stream({**view, "dil_w": qd, "rs_w": qr}, cfg,
                                    plan)
        return plan, stream, sd, sr, view
    return plan, tper.staged_stream(view, cfg, plan), None, None, view


def _matrix(stream, plan, m, l):
    """Matrix m of the stream (at layer l if per layer) as stored: [K, N]
    in its dtype, read from the stream's bytes."""
    dtype = plan.out_storage if m.name in ("out", "end") else plan.storage
    raw = stream.view(torch.uint8)
    start = m.offset + (l * plan.layer_bytes
                        if m.name in ("prev", "cur", "rs") else 0)
    q = raw[start:start + m.kq * m.row_bytes].view(dtype)
    return q.view(m.kq, m.Np, 4).permute(0, 2, 1).reshape(
        m.kq * 4, m.Np)[:m.K, :m.N]


@pytest.mark.parametrize("name,prec", K4_CASES)
def test_k4_stream_unlays_to_the_storage_values(name, prec):
    cfg, B = MODEL_CFG, 2
    params = _params(cfg, seed=6)
    plan, stream, sd, sr, view = _k4_stream(params, cfg, B, name, prec)
    assert stream.numel() * stream.element_size() == plan.stream_bytes
    assert stream.dtype == (torch.uint8 if plan.storage != plan.out_storage
                            else plan.storage)
    R = cfg.R
    if name == "int8":
        qd, _, qr, _ = tper.quantize_stream_weights(params)
        q_layers = [(qd[l, :R], qd[l, R:], qr[l]) for l in range(3)]
    layers, tail = tper.staged_stacks(view, cfg)
    for l in range(cfg.num_layers):
        for i, m in enumerate(plan.matrices[:3]):
            w = _matrix(stream, plan, m, l)
            assert w.dtype == STORAGES[name]
            if name == "int8":
                assert torch.equal(w, q_layers[l][i])
                # Wprev and Wcur share dil_w's column scales
                cols = sd[l] if m.name in ("prev", "cur") else sr[l]
                op = tsg.roundings(prec)[0]
                assert torch.equal(op(w.to(torch.float32) * cols),
                                   layers[l][i])
            else:
                assert torch.equal(w.to(torch.float32), layers[l][i])
    for m, w in zip(plan.matrices[3:], tail):
        got = _matrix(stream, plan, m, 0)
        assert got.dtype == plan.out_storage
        assert torch.equal(got.to(torch.float32), w)


class _StreamProducts:
    """The staged K4's products from its stream's bytes: each column sums
    its quads in k order, a rounded product and a rounded add per term; a
    stored int8 weight is the rounded product q * s (then the precision's
    operand rounding), bf16 widens exactly."""

    def __init__(self, stream, plan, cfg, dil_s, rs_s, prec):
        self.stream, self.plan, self.cfg = stream, plan, cfg
        self.mats = {m.name: m for m in plan.matrices}
        self.scales = {"prev": dil_s, "cur": dil_s, "rs": rs_s}
        self.op = tsg.roundings(prec)[0]

    def __call__(self, name, l, act):
        m = self.mats[name]
        w = _matrix(self.stream, self.plan, m, l)
        if w.dtype == torch.int8:
            w = self.op(w.to(torch.float32) * self.scales[name][l][None, :])
        w = w.to(torch.float32)
        acc = torch.zeros(m.N)
        for k in range(m.K):
            acc = acc + act[k] * w[k]
        return acc


@pytest.mark.parametrize("name,prec", K4_CASES)
def test_model_of_the_staged_k4(name, prec):
    torch.set_num_threads(1)
    cfg, B, T = MODEL_CFG, 2, 5
    params = _params(cfg, seed=8)
    plan, stream, sd, sr, view = _k4_stream(params, cfg, B, name, prec)
    cond, sel = _inputs(cfg, B, T, 4)
    cond_pre = (cond + view["dil_b"][None, :, None, :]).contiguous()
    t0 = torch.full((B,), 2, dtype=torch.int64)
    n = torch.full((B,), T, dtype=torch.int32)

    def fresh():
        return (tper.init_ring(cfg, B, "cpu", dtype=tsg.ring_dtype(prec)),
                torch.full((2, B), cfg.silence_bin, dtype=torch.int32))
    q = model_run(cfg, view, _StreamProducts(stream, plan, cfg, sd, sr, prec),
                  t0, cond_pre, sel, *fresh(), n, dump=True, prec=prec)
    r = model_run(cfg, view, _RowProducts(view, cfg), t0, cond_pre, sel,
                  *fresh(), n, dump=True, prec=prec)
    assert torch.equal(q[0], r[0]) and torch.equal(q[2], r[2])
    as_bits = (lambda t: t.view(torch.int16)) if prec == "bf16" else (
        lambda t: t)
    assert torch.equal(as_bits(q[1]), as_bits(r[1]))
    for k in q[3]:
        assert torch.equal(q[3][k], r[3][k]), k
    out = tper.generate_plain(cfg, view, 2, cond_pre, sel, *fresh(), T,
                              prec=prec)
    assert torch.equal(q[0], out[0]) and torch.equal(q[2], out[2])
    # the generator on the CPU takes the same view
    gen = tper.make_persistent_generator(
        cfg, B, stream_weights=True, **STORAGE_KW[name],
        **{"exact": {}, "fast": {"fast_math": True},
           "bf16": {"compute_dtype": torch.bfloat16}}[prec])
    assert gen.route.kernel == "staged_stream"
    assert torch.equal(gen(params, 2, cond_pre, sel, *fresh())[0], q[0])


def test_model_of_the_int8_k4_matches_the_jax_streaming_kernel():
    """The staged K4's model on int8 stacks against the JAX package's K4
    with stream_weights=True, stream_quant=True in interpret mode."""
    torch.set_num_threads(1)
    cfg, batch, samples, chunk = STREAM_CONFIGS[0]
    ref_w, cond, sel = make_case(cfg, batch, samples, seed=57)
    params_np = params_lib.to_canonical(ref_w, cfg)
    y_j, _, ys_j = run_stream(cfg, {k: jnp.asarray(v)
                                    for k, v in params_np.items()},
                              cond, sel, batch, chunk, stream_quant=True)
    pcfg = port_cfg(cfg)
    params = tparams.canonical_to_torch(params_np, "cpu")
    plan, stream, sd, sr, view = _k4_stream(params, pcfg, batch, "int8",
                                            "exact")
    cond_pre = (torch.from_numpy(cond)
                + view["dil_b"][None, :, None, :]).contiguous()
    t0 = torch.zeros(batch, dtype=torch.int64)
    n = torch.full((batch,), samples, dtype=torch.int32)
    y, _, ys, _ = model_run(
        pcfg, view, _StreamProducts(stream, plan, pcfg, sd, sr, "exact"), t0,
        cond_pre, torch.from_numpy(sel), tper.init_ring(pcfg, batch, "cpu"),
        torch.full((2, batch), pcfg.silence_bin, dtype=torch.int32), n)
    assert int((y.numpy().T != y_j).sum()) == 0
    assert np.array_equal(ys.numpy(), np.asarray(ys_j))


def test_k4_source_holds_every_storage_and_precision():
    """Each precision's library of the staged step has its lockstep entry
    point (K1, K2, K3, K4) and its ragged one (K5); the kernel's storage and
    mode ids are the wrapper's."""
    with open(os.path.join(tbuild.CSRC_DIR, "staged_generate.cu")) as f:
        src = f.read()
    for prec, kernel in tper.PERSISTENT_KERNELS.items():
        assert kernel.source == tbuild.unit("staged_generate.cu", prec)
        assert kernel.source in tbuild.UNITS
        assert re.search(rf"NVW_STAGED_ENTRY\({kernel.symbol}, ", src)
        ragged = tper.RAGGED_KERNELS[prec]
        assert ragged.source == kernel.source
        assert re.search(rf"NVW_STAGED_RAGGED_ENTRY\({ragged.symbol}, ",
                         src)
    for name, sid in (("F32", 0), ("BF16", 1), ("I8", 2)):
        assert f"kStorage{name} = {sid};" in src
    assert tper._STORAGE_IDS == {torch.float32: 0, torch.bfloat16: 1,
                                 torch.int8: 2}
    with open(os.path.join(tbuild.CSRC_DIR, "step_common.cuh")) as f:
        common = f.read()
    for mode, mid in tper._MODE_IDS.items():
        assert f"kMode{mode.capitalize()} = {mid};" in common
    for prec, kernel in tper.GENERIC_KERNELS.items():
        assert kernel.source == tbuild.unit("generic_generate.cu", prec)
        assert tper.GENERIC_RAGGED_KERNELS[prec].source == kernel.source


# where each argument sits in the lockstep entry point's C signature
# (csrc/staged_generate.cu NVW_STAGED_ENTRY)
_ENTRY_ARG = {"stream": 1, "dil_s": 2, "rs_s": 3, "dumps": slice(13, 18),
              "p_seq": 18, "t0": 19, "seed": 20, "n_valid": 21,
              "widths": slice(22, 27), "mode": 29, "storage": 30, "plan": 31}


@pytest.mark.parametrize("mode", tsg.MODES)
@pytest.mark.parametrize("name,prec", [("fp32", "exact"), ("bf16", "fast"),
                                       ("int8", "bf16")])
def test_one_launcher_passes_the_lockstep_entry_point_its_arguments(
        monkeypatch, mode, name, prec):
    """Every lockstep call of the staged step (K1, K2, K3, K4) goes through
    `_launch_staged` to the one entry point of its precision: as many
    arguments as its argtypes, the mode and storage ids the kernel reads,
    p_seq only in mode forced, the int8 scales only beside int8 stacks,
    the dumps only when asked, and no launch for no steps.  A recorder
    stands in for the library."""
    cfg, B, T = MODEL_CFG, 2, 3
    storage = STORAGES[name]
    plan = tper.staged_plan(cfg, B, prec, storage)
    plan_arr = tper._plan_array(plan)
    kernel = tper.PERSISTENT_KERNELS[prec]
    calls = []

    class Recorder:
        argtypes = kernel.argtypes

        def __call__(self, *args):
            calls.append(args)

    monkeypatch.setitem(tper.PERSISTENT_KERNELS, prec, Recorder())
    params = _params(cfg)
    scales = ((params["dil_b"], params["rs_b"]) if name == "int8"
              else (None, None))
    stored = (torch.zeros(plan.stream_bytes, dtype=torch.uint8), *scales)
    cond, sel = _inputs(cfg, B, T, 3)
    ring = tper.init_ring(cfg, B, "cpu", dtype=tsg.ring_dtype(prec))
    ys = torch.zeros((2, B), dtype=torch.int32)
    sched = tper.fifo_schedule(cfg, "cpu")
    dump = mode == "argmax"

    def launch(n):
        return tper._launch_staged(cfg, plan, plan_arr, params, stored, sched,
                                   5, cond, sel, ring, ys, n, mode, dump, 7,
                                   prec, 0)
    out = launch(0)
    assert not calls and not out[0].any()
    out = launch(T)
    (args,) = calls
    assert len(args) == len(kernel.argtypes) == 33
    at = {k: args[i] for k, i in _ENTRY_ARG.items()}
    assert at["mode"] == tper._MODE_IDS[mode] == tsg.MODES.index(mode)
    assert at["storage"] == tper._STORAGE_IDS[storage]
    assert at["plan"] == ctypes.addressof(plan_arr)
    assert at["stream"] == stored[0].data_ptr()
    assert (at["dil_s"] is None) == (at["rs_s"] is None) == (name != "int8")
    assert (at["p_seq"] is not None) == (mode == "forced")
    assert all((d is not None) == dump for d in at["dumps"])
    assert (at["t0"], at["seed"], at["n_valid"]) == (5, 7, T)
    assert at["widths"] == (B, cfg.num_layers, cfg.R, cfg.S, cfg.A)
    assert len(out) == 3 + 5 * dump + (mode == "forced")
    assert out[1] is ring and out[2] is ys


# where each argument sits in the generic lockstep entry point's C
# signature (csrc/generic_generate.cu NVW_GENERATE_ENTRY)
_GENERIC_ARG = {"sel": 9, "dumps": slice(14, 19), "p_seq": 19, "t0": 20,
                "seed": 21, "n_valid": 22, "widths": slice(23, 28),
                "mode": 30}


@pytest.mark.parametrize("mode", tsg.MODES)
def test_generic_launcher_passes_every_mode_to_one_entry_point(monkeypatch,
                                                               mode):
    """K1, K2 and K3 on the generic kernel go through `_launch_kernel` to
    its one lockstep entry point: as many arguments as its argtypes, the
    mode id the kernel reads, p_seq only in mode forced, the seed modulo
    2^64, the dumps only when asked, and no launch for no steps.  A
    recorder stands in for the library."""
    cfg, B, T = MODEL_CFG, 2, 3
    kernel = tper.GENERIC_KERNELS["exact"]
    calls = []

    class Recorder:
        argtypes = kernel.argtypes

        def __call__(self, *args):
            calls.append(args)

    monkeypatch.setitem(tper.GENERIC_KERNELS, "exact", Recorder())
    params = _params(cfg)
    cond, sel = _inputs(cfg, B, T, 3)
    ring = tper.init_ring(cfg, B, "cpu")
    ys = torch.zeros((2, B), dtype=torch.int32)
    sched = tper.fifo_schedule(cfg, "cpu")
    dump = mode == "argmax"

    def launch(n):
        return tper._launch_kernel(cfg, params, sched, 5, cond, sel, ring, ys,
                                   n, mode, dump, -1, "exact", 0)
    out = launch(0)
    assert not calls and not out[0].any()
    out = launch(T)
    (args,) = calls
    assert len(args) == len(kernel.argtypes) == 32
    at = {k: args[i] for k, i in _GENERIC_ARG.items()}
    assert at["mode"] == tper._MODE_IDS[mode] == tsg.MODES.index(mode)
    assert at["sel"] == sel.data_ptr()
    assert (at["p_seq"] is not None) == (mode == "forced")
    assert all((d is not None) == dump for d in at["dumps"])
    assert (at["t0"], at["seed"], at["n_valid"]) == (5, 2 ** 64 - 1, T)
    assert at["widths"] == (B, cfg.num_layers, cfg.R, cfg.S, cfg.A)
    assert len(out) == 3 + 5 * dump + (mode == "forced")
    assert out[1] is ring and out[2] is ys


@pytest.mark.parametrize("name", ["exp", "tanh", "sigmoid"])
def test_exact_fn_on_offset_views_matches_numpy(name):
    """K0a takes 16-byte vectors only where both pointers are aligned; on
    the CPU the wrapper's plain version must give the numpy twins' bits on
    an offset view as on the whole tensor."""
    rng = np.random.RandomState(1)
    x = rng.uniform(-30, 30, 1027).astype(np.float32)
    want = getattr(jem, f"{name}_np")(x)
    got = em.exact_fn(name, torch.from_numpy(x)[3:]).numpy()
    assert np.array_equal(got.view(np.int32), want[3:].view(np.int32))


def test_engine_holds_one_copy_of_the_weights_for_k1_k2_and_k3():
    """The engine's generators share their storage by what it holds: K1 and
    the staged K2/K3 read one stream, so their storage is one entry (here,
    on the CPU, the fast precision's rounded view: the same tensors)."""
    cfg = tcfg.WaveNetConfig(num_layers=2, R=16, S=32, A=256, max_dilation=2)
    B, T = 2, 3
    eng = WaveNetInfer(num_layers=2, max_dilation=2, R=16, S=32, A=256,
                       max_batch=B, device="cpu", fast_math=True)
    eng.set_reference_weights(tparams.random_reference_weights(cfg, seed=2))
    rng = np.random.RandomState(1)
    cond = rng.uniform(-0.5, 0.5, (T, 2, B, 32)).astype(np.float32)
    eng.set_inputs(cond, rng.uniform(0, 1, (T, B)).astype(np.float32))
    y = eng.run(T, B)
    eng.run(T, B, mode="prng")
    eng.set_inputs(cond, y.T.astype(np.float32))
    eng.run(T, B, mode="forced")
    routes = {k[1]: g[0].route.kernel if isinstance(g, tuple) else
              g.route.kernel for k, g in eng._gens.items()}
    assert routes == {"sample": "staged", "prng": "staged_stream",
                      "forced": "staged_stream"}
    assert len(eng._stored) == 1
    (entry,) = eng._stored.values()
    assert entry["view"]["dil_w"].dtype == torch.float32
