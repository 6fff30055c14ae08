"""K1/K5's staged design on the CPU (`ops/persistent.py::staged_plan`,
`staged_stream`, `staged_columns`; the kernel, `csrc/staged_generate.cu`,
runs only on the card).

* The plan fits the H100's 227 KB block at the flagship, at config 4 and at
  the port tests' configs in each precision, and raises, with a message,
  for a geometry past the limit.  The numbers compiled into the kernel's
  fixed-width instances are the plan's at their widths.
* The thread-to-column map is a bijection onto each product's columns.
* The k-quad relayout round-trips, exactly for the bf16 stacks.
* A plain model of the kernel's arithmetic on the relaid stream: the prev
  half x_{t-d} Wprev of every layer computed ahead, at the step's start,
  from the FIFO as it stands; every product summed quad by quad in k order
  from the stream's bytes.  It equals the same model fed the canonical
  stacks (a k-ordered sum of rows) bit for bit in y, the ring, y_state and
  every dump, so a relayout or a product that takes a quad's terms out of
  order fails; and it equals `generate_plain` in y and y_state (the plain
  version's products are library matmuls, so its ring and dumps are held
  to the reference ladder) and the JAX interpret-mode kernel's samples,
  lockstep and ragged, in each precision.
"""

import os
import re

import numpy as np
import pytest
import torch

from nv_wavenet_tpu.models import params as params_lib
from nv_wavenet_tpu_torch import config as tcfg
from nv_wavenet_tpu_torch.models import params as tparams
from nv_wavenet_tpu_torch.ops import exact_math as em
from nv_wavenet_tpu_torch.ops import persistent as tper
from nv_wavenet_tpu_torch.ops import scan_generate as tsg
from nv_wavenet_tpu_torch.utils import build as tbuild

from tests.test_golden_vs_scan import make_case, rel_close
from tests.test_persistent_kernel import CONFIGS, run_kernel

BLOCK = tper.SMEM_PER_BLOCK - tper._STATIC_SMEM
CONFIG4 = tcfg.WaveNetConfig(num_layers=40, R=128, S=256, A=256,
                             max_dilation=128)
# the flagship, config 4 and the geometries the port's tests run
PLAN_CONFIGS = [
    (tcfg.FLAGSHIP_CONFIG, 16), (CONFIG4, 64), (tcfg.TEST_CONFIG_MED, 4),
    (tcfg.TEST_CONFIG_SMALL, 4),
    (tcfg.WaveNetConfig(num_layers=4, R=32, S=128, A=256, max_dilation=4), 16),
    (tcfg.WaveNetConfig(num_layers=2, R=36, S=100, A=256, max_dilation=2), 2),
    (tcfg.WaveNetConfig(num_layers=3, R=8, S=16, A=256, max_dilation=2), 2),
    (tcfg.WaveNetConfig(num_layers=4, R=32, S=128, A=1024, max_dilation=4), 200),
    (tcfg.WaveNetConfig(num_layers=60, R=256, S=256, A=256, max_dilation=8), 2),
    (tcfg.WaveNetConfig(num_layers=1, R=32, S=128, A=256, max_dilation=1), 2),
]
def unquads(q, K, N):
    """`tper.staged_quads` undone: the fp32 stack [K, N]."""
    kq, Np, _ = q.shape
    return q.to(torch.float32).permute(0, 2, 1).reshape(kq * 4, Np)[:K, :N]


MODEL_CFG = tcfg.WaveNetConfig(num_layers=3, R=12, S=20, A=32, max_dilation=2,
                               silence_bin=16)


@pytest.mark.parametrize("prec", tsg.PRECISIONS)
@pytest.mark.parametrize("cfg,batch", PLAN_CONFIGS)
def test_plan_fits_the_block(cfg, batch, prec):
    plan = tper.staged_plan(cfg, batch, prec)
    assert plan.smem_bytes <= BLOCK
    assert plan.threads == plan.chain_threads + plan.prev_threads + 32
    assert plan.threads <= tper.STAGED_MAX_THREADS
    assert plan.chain_slots >= 2 and plan.prev_slots == 2
    assert plan.chain_slots + plan.prev_slots <= 32   # a producer lane each
    assert plan.lookahead == min(cfg.num_layers, tper.STAGED_LOOKAHEAD)
    assert plan.storage == (torch.float32 if prec == "exact"
                            else torch.bfloat16)
    for m in plan.matrices:
        slot = plan.prev_slot_bytes if m.name == "prev" else plan.slot_bytes
        assert m.row_bytes % 16 == 0 and m.offset % 16 == 0
        assert 1 <= m.rows and m.rows * m.row_bytes <= slot
        assert (m.chunks - 1) * m.rows < m.kq <= m.chunks * m.rows
    assert plan.slot_bytes % 128 == 0 and plan.prev_slot_bytes % 128 == 0
    assert len(plan.kernel_args()) == 12 + 4 * 5 + 1
    assert plan.waves == -(-batch // tper.SMS)


def _fixed_widths():
    """{(geometry, precision): (R, S, A, Tc, Tp, rows...)} of the
    instances `csrc/staged_generate.cu` compiles for fixed widths, read
    from its `fixed_widths`."""
    with open(os.path.join(tbuild.CSRC_DIR, "staged_generate.cu")) as f:
        src = f.read()
    found = {}
    for geo, exact, nums in re.findall(
            r"geo == (\d+)( && prec == kPrecExact)?\s*\?\s*Fixed\{([\d, {}]+)\}\}",
            src):
        vals = tuple(int(v) for v in re.findall(r"\d+", nums))
        for prec in (("exact",) if exact else ("fast", "bf16")):
            found[(int(geo), prec)] = vals
    return found


@pytest.mark.parametrize("prec", tsg.PRECISIONS)
@pytest.mark.parametrize("geometry", [1, 2])
def test_fixed_width_instances_match_the_plan(geometry, prec):
    """The numbers compiled into a fixed-width instance are the plan's at
    its widths (the launch refuses a plan that differs), and the plan picks
    that instance at those widths with a full prev buffer only."""
    R, S, A = tper.STAGED_FIXED_WIDTHS[geometry - 1]
    cfg = tcfg.WaveNetConfig(num_layers=20, R=R, S=S, A=A, max_dilation=8)
    plan = tper.staged_plan(cfg, 16, prec)
    assert plan.geometry == geometry
    assert plan.kernel_args()[-1] == geometry
    assert _fixed_widths()[(geometry, prec)] == (
        R, S, A, plan.chain_threads, plan.prev_threads,
        *(m.rows for m in plan.matrices))
    # a thread owns NC columns, NC - STEP or none (`fixed_chunk`)
    cols = tper.staged_columns(cfg, plan)
    for name, threads, step in (("cur", plan.chain_threads, 2),
                                ("rs", plan.chain_threads, 1),
                                ("out", plan.chain_threads, 1),
                                ("prev", plan.prev_threads, 1)):
        per = np.bincount([t for t, _ in cols[name]], minlength=threads)
        nc = per.max()
        assert set(per.tolist()) <= {nc, nc - step, 0}, name
    short = tcfg.WaveNetConfig(num_layers=3, R=R, S=S, A=A, max_dilation=4)
    assert tper.staged_plan(short, 16, prec).geometry == 0
    other = tcfg.WaveNetConfig(num_layers=20, R=R, S=S // 2, A=A,
                               max_dilation=8)
    assert tper.staged_plan(other, 16, prec).geometry == 0


def test_plan_raises_past_the_limit(monkeypatch):
    wide = tcfg.WaveNetConfig(num_layers=2, R=32, S=128, A=16384,
                              max_dilation=2)
    with pytest.raises(ValueError, match="output columns"):
        tper.staged_plan(wide, 2)
    big = tcfg.WaveNetConfig(num_layers=2, R=512, S=256, A=256,
                             max_dilation=2)
    with pytest.raises(ValueError, match="Wprev"):
        tper.staged_plan(big, 2)
    # the flagship's rings in a block of 64,000 bytes
    monkeypatch.setattr(tper, "SMEM_PER_BLOCK", 64_000)
    with pytest.raises(ValueError, match="shared memory"):
        tper.staged_plan(tcfg.FLAGSHIP_CONFIG, 16)
    monkeypatch.undo()
    odd = tcfg.WaveNetConfig(num_layers=2, R=9, S=16, A=32, max_dilation=2)
    tper.staged_plan(odd, 2, "fast")
    with pytest.raises(ValueError, match="even"):
        tper.staged_plan(odd, 2, "bf16")


@pytest.mark.parametrize("cfg,batch", PLAN_CONFIGS[:6])
def test_column_map_is_a_bijection(cfg, batch):
    plan = tper.staged_plan(cfg, batch)
    cols = tper.staged_columns(cfg, plan)
    R, S, A = cfg.R, cfg.S, cfg.A
    want = {"cur": 2 * R, "prev": 2 * R, "rs": R + S, "out": A}
    for name, n in want.items():
        owned = [c for _, c in cols[name]]
        assert sorted(owned) == list(range(n)), name
        per_thread = np.bincount([t for t, _ in cols[name]])
        assert per_thread.max() <= tper.STAGED_MAX_COLUMNS
    threads = {"cur": plan.chain_threads, "rs": plan.chain_threads,
               "out": plan.chain_threads, "prev": plan.prev_threads}
    for name, n in threads.items():
        assert max(t for t, _ in cols[name]) < n
    # the chain's thread i owns Wcur's pair (i, R + i): the gate needs both
    pairs = {}
    for t, c in cols["cur"]:
        pairs.setdefault(t, set()).add(c % R)
    assert all(len(v) <= 2 for v in pairs.values())
    assert sorted(c for t, c in cols["cur"] if c < R) == list(range(R))
    for t, c in cols["cur"]:
        assert (t, (c + R) % (2 * R)) in cols["cur"]


@pytest.mark.parametrize("K,N", [(64, 128), (64, 320), (36, 136), (9, 37)])
def test_quads_round_trip(K, N):
    rng = np.random.RandomState(K * N)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    q = tper.staged_quads(w, torch.float32)
    assert q.shape == (-(-K // 4), -(-N // 4) * 4, 4)
    assert torch.equal(unquads(q, K, N), w)
    for k in range(K):   # element [q, n, u] is w[4q + u, n]
        assert torch.equal(q[k // 4, :N, k % 4], w[k])
    pad = q.permute(0, 2, 1).reshape(-1, q.shape[1])
    assert not pad[K:].any() and not pad[:, N:].any()
    wb = tsg.round_bf16(w)
    qb = tper.staged_quads(wb, torch.bfloat16)
    assert qb.dtype == torch.bfloat16
    assert torch.equal(unquads(qb, K, N), wb)


def _params(cfg, seed=5):
    rng = np.random.RandomState(seed)
    shapes = tparams.canonical_shapes(cfg.num_layers, cfg.R, cfg.S, cfg.A)
    return {k: torch.from_numpy(rng.uniform(-0.6, 0.6, s).astype(np.float32))
            for k, s in shapes.items()}


@pytest.mark.parametrize("prec", tsg.PRECISIONS)
def test_stream_holds_the_stacks(prec):
    cfg = MODEL_CFG
    view = tsg.product_view(_params(cfg), prec)
    plan = tper.staged_plan(cfg, 2, prec)
    stream = tper.staged_stream(view, cfg, plan)
    assert stream.dtype == plan.storage
    layers, tail = tper.staged_stacks(view, cfg)
    for l in range(cfg.num_layers):
        for m, w in zip(plan.matrices[:3], layers[l]):
            assert torch.equal(_stacks_of(stream, plan, m, l), w)
    for m, w in zip(plan.matrices[3:], tail):
        assert torch.equal(_stacks_of(stream, plan, m, 0), w)


def _stacks_of(stream, plan, m, l):
    """Matrix m of the stream (at layer l if per layer) as fp32 [K, N]."""
    eb = stream.element_size()
    start = (m.offset + (l * plan.layer_bytes if m.name in ("prev", "cur", "rs")
                         else 0)) // eb
    q = stream[start:start + m.kq * m.row_bytes // eb].view(m.kq, m.Np, 4)
    return unquads(q, m.K, m.N)


class _QuadProducts:
    """The kernel's products from the relaid stream: each column sums its
    quads in k order, a rounded product and a rounded add per term."""

    def __init__(self, stream, plan, cfg):
        self.stream, self.plan, self.cfg = stream, plan, cfg
        self.mats = {m.name: m for m in plan.matrices}

    def __call__(self, name, l, act):
        m = self.mats[name]
        eb = self.stream.element_size()
        start = (m.offset + (l * self.plan.layer_bytes
                             if name in ("prev", "cur", "rs") else 0)) // eb
        q = self.stream[start:start + m.kq * m.row_bytes // eb]
        q = q.view(m.kq, m.Np, 4).to(torch.float32)[:, :m.N]
        acc = torch.zeros(m.N)
        for k in range(m.K):
            acc = acc + act[k] * q[k // 4, :, k % 4]
        return acc


class _RowProducts:
    """The same sums over the canonical stacks, row by row in k order."""

    def __init__(self, view, cfg):
        layers, tail = tper.staged_stacks(view, cfg)
        self.layers = [dict(zip(("prev", "cur", "rs"), s)) for s in layers]
        self.tail = dict(zip(("out", "end"), tail))

    def __call__(self, name, l, act):
        w = self.layers[l][name] if name in ("prev", "cur", "rs") \
            else self.tail[name]
        acc = torch.zeros(w.shape[1])
        for k in range(w.shape[0]):
            acc = acc + act[k] * w[k]
        return acc


def model_run(cfg, view, prod, t0, cond_pre, sel, ring, y_state, n_valid,
              mode="sample", dump=False, prec="exact"):
    """The kernel's step, one row at a time (rows never interact): per row
    its own clock t0[b] and length n_valid[b].  Returns y [T, B], ring and
    y_state (updated in place) and the last step's dumps when dump."""
    op, st = tsg.roundings(prec)
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    T, _, B, _ = cond_pre.shape
    y = torch.zeros((T, B), dtype=torch.int32)
    dumps = None
    for b in range(B):
        y_prev, y_cur = int(y_state[0, b]), int(y_state[1, b])
        for j in range(int(n_valid[b])):
            t = int(t0[b]) + j
            slots = [off + (t & (d - 1))
                     for off, d in zip(cfg.ring_offsets, cfg.dilations)]
            # the prev warps: every layer's x_{t-d} Wprev, ahead of the chain
            zp = [prod("prev", l, op(ring[slots[l], b].to(torch.float32)))
                  for l in range(L)]
            x = st(tsg.embed_lookup(view["embed"], torch.tensor([y_prev]),
                                    torch.tensor([y_cur]), A,
                                    cfg.tanh_embed)[0])
            skip = torch.zeros(S)
            xts, skips = [], []
            for l in range(L):
                zc = prod("cur", l, op(x))
                c = cond_pre[j, l, b]
                zt = (zp[l][:R] + zc[:R]) + c[:R]
                zg = (zp[l][R:] + zc[R:]) + c[R:]
                ring[slots[l], b] = x.to(ring.dtype)
                h = op(em.tanh(zt) * em.sigmoid(zg))
                rs = prod("rs", l, h)
                x = st((rs[:R] + view["rs_b"][l, :R]) + x)
                skip = (skip + rs[R:]) + view["rs_b"][l, R:]
                xts.append(x)
                skips.append(skip)
            skip = torch.clamp_min(skip, 0.0)
            skips[-1] = skip
            zs = torch.clamp_min(prod("out", 0, op(skip)) + view["out_b"],
                                 0.0)
            za = prod("end", 0, op(zs)) + view["end_b"]
            e, cum = em.softmax_cumsum(za[None])
            if mode == "argmax":
                yj = int(torch.argmax(za))
            else:
                yj = int(em.select_from_cumsum(cum, sel[j, b].reshape(1, 1),
                                               A, cfg.silence_bin)[0])
            if dump and j == int(n_valid[b]) - 1:
                if dumps is None:
                    dumps = {"xt": torch.zeros(L, B, R),
                             "skip": torch.zeros(L, B, S),
                             "zs": torch.zeros(B, A), "za": torch.zeros(B, A),
                             "p": torch.zeros(B, A)}
                dumps["xt"][:, b] = torch.stack(xts)
                dumps["skip"][:, b] = torch.stack(skips)
                dumps["zs"][b], dumps["za"][b] = zs, za
                dumps["p"][b] = em.softmax_p(e, cum)[0]
            y[j, b] = yj
            y_prev, y_cur = y_cur, yj
        y_state[0, b], y_state[1, b] = y_prev, y_cur
    return y, ring, y_state, dumps


def _inputs(cfg, B, T, seed):
    rng = np.random.RandomState(seed)
    cond = torch.from_numpy(rng.uniform(-0.5, 0.5, (T, cfg.num_layers, B,
                                                    2 * cfg.R))
                            .astype(np.float32))
    sel = torch.from_numpy(rng.uniform(0, 1, (T, B)).astype(np.float32))
    return cond, sel


def _fresh(cfg, B, prec):
    return (tper.init_ring(cfg, B, "cpu", dtype=tsg.ring_dtype(prec)),
            torch.full((2, B), cfg.silence_bin, dtype=torch.int32))


LADDER = (1e-2, 3e-4)


@pytest.mark.parametrize("prec", tsg.PRECISIONS)
@pytest.mark.parametrize("ragged", (False, True))
def test_model_of_the_kernel(prec, ragged):
    torch.set_num_threads(1)
    cfg, B, T = MODEL_CFG, 3, 6
    params = _params(cfg)
    view = tsg.product_view(params, prec)
    plan = tper.staged_plan(cfg, B, prec)
    stream = tper.staged_stream(view, cfg, plan)
    cond, sel = _inputs(cfg, B, T, 7 + ragged)
    cond_pre = (cond + params["dil_b"][None, :, None, :]).contiguous()
    if ragged:
        t0 = torch.tensor([5, 0, 2], dtype=torch.int64)
        n_valid = torch.tensor([6, 0, 4], dtype=torch.int32)
    else:
        t0 = torch.full((B,), 3, dtype=torch.int64)
        n_valid = torch.full((B,), T, dtype=torch.int32)
    outs = {}
    for name, prod in (("quads", _QuadProducts(stream, plan, cfg)),
                       ("rows", _RowProducts(view, cfg))):
        outs[name] = model_run(cfg, view, prod, t0, cond_pre, sel,
                               *_fresh(cfg, B, prec), n_valid,
                               dump=not ragged, prec=prec)
    q, r = outs["quads"], outs["rows"]
    assert torch.equal(q[0], r[0]) and torch.equal(q[2], r[2])
    assert torch.equal(q[1].view(torch.int16) if prec == "bf16" else q[1],
                       r[1].view(torch.int16) if prec == "bf16" else r[1])
    if not ragged:
        for k in q[3]:
            assert torch.equal(q[3][k], r[3][k]), k
    # the plain version: lockstep (K1) or per row (K5)
    if ragged:
        out = tper.generate_plain(cfg, params, t0, cond_pre, sel,
                                  *_fresh(cfg, B, prec), n_valid, prec=prec)
    else:
        out = tper.generate_plain(cfg, params, 3, cond_pre, sel,
                                  *_fresh(cfg, B, prec), T, dump=True,
                                  prec=prec)
    assert torch.equal(q[0], out[0]) and torch.equal(q[2], out[2])
    assert rel_close(out[1].to(torch.float32).numpy(),
                     q[1].to(torch.float32).numpy(), *LADDER)
    if not ragged:
        for k, (tol, atol) in zip(("xt", "skip", "zs", "za", "p"),
                                  (LADDER, LADDER, (1e-4, 2e-5), (1e-4, 2e-5),
                                   (1e-3, None))):
            assert rel_close(out[3 + tper._DUMP_KEYS.index(k)].numpy(),
                             q[3][k].numpy(), tol, atol), k


def test_model_argmax_matches_plain():
    torch.set_num_threads(1)
    cfg, B, T = MODEL_CFG, 2, 4
    params = _params(cfg, seed=9)
    plan = tper.staged_plan(cfg, B)
    stream = tper.staged_stream(params, cfg, plan)
    cond, sel = _inputs(cfg, B, T, 3)
    cond_pre = (cond + params["dil_b"][None, :, None, :]).contiguous()
    t0 = torch.zeros(B, dtype=torch.int64)
    n = torch.full((B,), T, dtype=torch.int32)
    y, _, ys, _ = model_run(cfg, params, _QuadProducts(stream, plan, cfg), t0,
                            cond_pre, sel, *_fresh(cfg, B, "exact"), n,
                            mode="argmax")
    out = tper.generate_plain(cfg, params, 0, cond_pre, sel,
                              *_fresh(cfg, B, "exact"), T, mode="argmax")
    assert torch.equal(y, out[0]) and torch.equal(ys, out[2])


def test_model_matches_the_jax_interpret_kernel():
    torch.set_num_threads(1)
    cfg, batch, samples, chunk = CONFIGS[0]
    ref_w, cond, sel = make_case(cfg, batch, samples, seed=11)
    params_np = params_lib.to_canonical(ref_w, cfg)
    y_j, _, ys_j, _ = run_kernel(cfg, params_np, cond, sel, batch, chunk)
    pcfg = tcfg.WaveNetConfig(num_layers=cfg.num_layers, R=cfg.R, S=cfg.S,
                              A=cfg.A, max_dilation=cfg.max_dilation,
                              tanh_embed=cfg.tanh_embed)
    params = tparams.canonical_to_torch(params_np, "cpu")
    plan = tper.staged_plan(pcfg, batch)
    stream = tper.staged_stream(params, pcfg, plan)
    cond_pre = (torch.from_numpy(cond)
                + params["dil_b"][None, :, None, :]).contiguous()
    t0 = torch.zeros(batch, dtype=torch.int64)
    n = torch.full((batch,), samples, dtype=torch.int32)
    y, _, ys, _ = model_run(pcfg, params, _QuadProducts(stream, plan, pcfg),
                            t0, cond_pre, torch.from_numpy(sel),
                            *_fresh(pcfg, batch, "exact"), n)
    assert np.array_equal(y.numpy().T, y_j)
    assert np.array_equal(ys.numpy(), np.asarray(ys_j))


def test_cuda_launch_without_card_uses_plain_version():
    """On the CPU the wrapper runs the plain version and counts no launch
    of K1 or K5; their plan is made only for a CUDA launch."""
    cfg, B, T = MODEL_CFG, 2, 3
    params = _params(cfg)
    cond, sel = _inputs(cfg, B, T, 1)
    cond_pre = (cond + params["dil_b"][None, :, None, :]).contiguous()
    before = (tper.PERSISTENT_KERNELS["exact"].launches,
              tper.RAGGED_KERNELS["exact"].launches)
    gen = tper.make_persistent_generator(cfg, B)
    gen(params, 0, cond_pre, sel, *_fresh(cfg, B, "exact"))
    gen5 = tper.make_persistent_generator(cfg, B, ragged=True)
    gen5(params, torch.zeros(B, dtype=torch.int64), cond_pre, sel,
         *_fresh(cfg, B, "exact"), torch.full((B,), T, dtype=torch.int32))
    assert before == (tper.PERSISTENT_KERNELS["exact"].launches,
                      tper.RAGGED_KERNELS["exact"].launches)
    assert tper.PERSISTENT_KERNELS["exact"].source == "staged_generate.cu"
    assert tper.RAGGED_KERNELS["bf16"].source == "staged_generate.cu@bf16"
