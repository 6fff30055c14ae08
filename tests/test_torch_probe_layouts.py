"""The Hopper layouts of probe P5 and the vectorised P1 on the CPU
(`tools/probe_stage.py`, `tools/probe_exact_math.py`; kernels in
`csrc/probes.cu`).

  * "stream" and "cluster" through `make_chain` on CPU tensors equal
    `chain_plain` in both precisions;
  * the plans hold the flagship's D=43 at B=1 and 16 (one row a CTA and
    the whole batch) and raise before any launch where the cluster's
    slices pass a block's 227 KB, where R does not divide by the cluster,
    where the stream's ring does not fit and where the workers do not;
  * `instance_shapes`, which the card's holds run, gives each compiled
    instance of the stream and the cluster (rows a worker, R unrolled or
    not) a shape its plan takes;
  * the cluster's column map is a bijection onto the 2R columns with (i,
    R+i) on one CTA, and `quad_weights` places every weight once;
  * a model of the stream's ring: stage s in slot s mod S, read after it
    lands and never overwritten before it is read, under the kernel's
    parities and any interleaving of producer and consumers;
  * P1's float4/tail split covers each index once (n = 131,072, n not a
    multiple of 4, an offset view);
  * the floor `utils/profiling.STAGE_NS` is read from: the exact, gated
    stage at B=16, R=64, D=43 in every layout.
"""

import numpy as np
import pytest
import torch

from nv_wavenet_tpu_torch.tools import probe_exact_math as pem
from nv_wavenet_tpu_torch.tools import probe_stage as ps

LAYOUTS = ("stream", "cluster")


# models of the kernels' index and counter arithmetic (csrc/probes.cu)
P1_THREADS = 256           # a block (kThreads)
P1_BLOCKS_PER_SM = 64      # the grid's cap (kP1BlocksPerSM)


def p1_blocks(n: int, n4: int, sms: int) -> int:
    """P1's grid (NVW_FMA_PROBE): a thread per float4 and tail element, in
    blocks of P1_THREADS, at most P1_BLOCKS_PER_SM blocks an SM."""
    work = n4 + (n - 4 * n4)
    return max(1, min(-(-work // P1_THREADS), sms * P1_BLOCKS_PER_SM))


def element_order(n: int, n4: int, blocks: int) -> np.ndarray:
    """The elements fma_probe_kernel's threads touch, thread after thread
    in its loop order: float4 i (elements 4i .. 4i+3) for i = first, first +
    stride, ... below n4 (two a trip, then one), then the tail elements 4 n4
    + first, + stride, ... below n."""
    stride = blocks * P1_THREADS
    out = []
    for first in range(stride):
        i = first
        while i + stride < n4:
            out += [4 * i + e for e in range(4)]
            out += [4 * (i + stride) + e for e in range(4)]
            i += 2 * stride
        if i < n4:
            out += [4 * i + e for e in range(4)]
        out += range(4 * n4 + first, n, stride)
    return np.asarray(out, np.int64)


def ring_model(T: int, D: int, slots: int) -> dict:
    """stage_stream_kernel's ring as its counters run it: for stage s the
    producer's slot and the parity it waits on `empty` (s >= slots: the
    release of stage s - slots; else -1), and the consumers' slot and the
    parity they wait on `full`.  Arrays of T D entries."""
    out = {k: np.zeros(T * D, np.int64) for k in
           ("producer_slot", "empty_parity", "consumer_slot", "full_parity")}
    slot, phase = 0, 0
    for s in range(T * D):            # the producer's loop
        out["producer_slot"][s] = slot
        out["empty_parity"][s] = phase ^ 1 if s >= slots else -1
        slot += 1
        if slot == slots:
            slot, phase = 0, phase ^ 1
    slot, phase = 0, 0
    for s in range(T * D):            # the consumers' loops, t then d
        out["consumer_slot"][s] = slot
        out["full_parity"][s] = phase
        slot += 1
        if slot == slots:
            slot, phase = 0, phase ^ 1
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tensors are tiny: torch's intra-op threads cost more than
    they save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(B, R, D, groups, seed=5):
    rng = np.random.RandomState(seed)
    w = rng.uniform(-0.15, 0.15, (D, R, 2 * R)).astype(np.float32)
    x = rng.uniform(-1, 1, (groups, B, R)).astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy(x)


@pytest.mark.parametrize("precision", ps.PRECISIONS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_on_cpu_is_the_plain_version(layout, precision):
    w, x = inputs(4, 16, 3, 2)
    for gate in (True, False):
        for rows in (1, 2, 4):
            run = ps.make_chain(4, 16, 3, 2, precision, gate, 2, rows, layout)
            assert torch.equal(run(w, x),
                               ps.chain_plain(w, x, 2, gate, precision))


@pytest.mark.parametrize("B,rows", [(1, 1), (16, 1), (16, 16), (16, 2)])
def test_plans_hold_the_flagship(B, rows):
    R, D = ps.R_DEFAULT, ps.D_DEFAULT
    sp = ps.stream_plan(B, R, D, 1, rows)
    assert sp.ways >= 2 and sp.smem_bytes <= ps.SMEM_PER_BLOCK
    assert sp.workers * sp.rows_per_worker == rows * R
    assert sp.workers <= ps.MAX_WORKERS
    cp = ps.cluster_plan(B, R, D, 1, rows)
    # the slices of every W_d (176,128 bytes at 8 CTAs) and two x buffers
    assert cp.ways == ps.CLUSTER == 8
    assert cp.smem_bytes == 176128 + 2 * rows * R * 4 + 32
    assert cp.smem_bytes <= ps.SMEM_PER_BLOCK
    assert cp.workers * cp.rows_per_worker == rows * R // ps.CLUSTER


@pytest.mark.parametrize("layout,kw", [
    ("cluster", dict(D=57)),                   # 233,472 bytes of slices
    ("cluster", dict(D=55, rows=16)),          # slices fit, x does not
    ("cluster", dict(R=36)),                   # 8 does not divide R
    ("cluster", dict(R=4)),                    # nor this one
    ("cluster", dict(rows=5)),                 # rows do not divide B
    ("stream", dict(R=128)),                   # one 128 KB stage fits
    ("stream", dict(R=66)),                    # not whole k-quads
    ("stream", dict(rows=3)),                  # rows do not divide B
    ("stream", dict(B=32, rows=32, groups=2)),  # 64 rows: 1024 workers
    ("cluster", dict(B=128, rows=128, groups=2,
                     D=1)),                    # 256 rows of 8 pairs
], ids=["cluster_d57", "cluster_x", "cluster_r36", "cluster_r4",
        "cluster_rows", "stream_r128", "stream_r66", "stream_rows",
        "stream_workers", "cluster_workers"])
def test_plans_raise_before_launch(layout, kw):
    args = dict(B=ps.B_DEFAULT, R=ps.R_DEFAULT, D=ps.D_DEFAULT, groups=1,
                rows=1)
    args.update(kw)
    with pytest.raises(ValueError):
        if layout == "stream":
            ps.stream_plan(**args)
        else:
            ps.cluster_plan(**args)
    with pytest.raises(ValueError):
        ps.make_chain(T=1, weights=layout, **args)


INSTANCES = [(layout, np_, R) for layout in LAYOUTS for np_ in (1, 2, 4)
             for R in (ps.R_DEFAULT, 32)]


@pytest.mark.parametrize("layout,np_,R", INSTANCES)
def test_instance_shapes_reach_every_instance(layout, np_, R):
    shapes = ps.instance_shapes()
    assert set(shapes) == set(INSTANCES)
    sh = shapes[(layout, np_, R)]
    plan = (ps.stream_plan if layout == "stream" else ps.cluster_plan)(
        sh["B"], R, 3, sh["groups"], sh["rows"])
    assert plan.rows_per_worker == np_
    # two groups and two CTAs or clusters: row_offset's arithmetic
    assert sh["groups"] == 2 and sh["B"] == 2 * sh["rows"]
    run = ps.make_chain(sh["B"], R, 3, 1, "exact", True, sh["groups"],
                        sh["rows"], layout)
    w, x = inputs(sh["B"], R, 3, sh["groups"])
    assert torch.equal(run(w, x), ps.chain_plain(w, x, 1))


@pytest.mark.parametrize("R,cluster", [(64, 8), (64, 16), (16, 8), (8, 8),
                                       (64, 1)])
def test_cluster_column_map_is_a_bijection(R, cluster):
    cols = ps.cluster_columns(R, cluster).numpy()
    h = R // cluster
    assert cols.shape == (cluster, 2 * h)
    assert np.array_equal(np.sort(cols.ravel()), np.arange(2 * R))
    # (i, R+i) on the same CTA, at local places j and h + j
    assert np.array_equal(cols[:, h:], cols[:, :h] + R)
    assert np.all(cols[:, :h] < R)
    # CTA c owns the gate outputs of its slice c h .. c h + h - 1
    assert np.array_equal(cols[:, :h].ravel(), np.arange(R))


@pytest.mark.parametrize("cluster", [1, 8])
def test_quad_weights_place_every_weight_once(cluster):
    D, R = 2, 16
    w = torch.arange(D * R * 2 * R, dtype=torch.float32).reshape(D, R, 2 * R)
    wq = ps.quad_weights(w, cluster)
    h = R // cluster
    assert wq.shape == (cluster, D, R // 4, 2 * h, 4) and wq.is_contiguous()
    assert np.array_equal(np.sort(wq.numpy().ravel()),
                          np.arange(w.numel(), dtype=np.float32))
    cols = ps.cluster_columns(R, cluster)
    for c, d, k, n in [(0, 0, 0, 0), (cluster - 1, 1, 13, 2 * h - 1),
                       (cluster // 2, 1, 6, h)]:
        assert wq[c, d, k // 4, n, k % 4] == w[d, k, cols[c, n]]


def simulate_ring(T, D, S, seed):
    """The stream's protocol under a random interleaving: the producer
    fills stage s into its slot after waiting on `empty` with the model's
    parity, the consumers read stage s after waiting on `full`, then
    release the slot.  mbarrier try_wait.parity(p) passes once the phase
    of parity p has completed: completions & 1 != p.  Returns the stage
    the consumers found in each slot they read."""
    model = ring_model(T, D, S)
    full, empty = [0] * S, [0] * S   # completed phases
    slots = [None] * S
    rng = np.random.RandomState(seed)
    n, fill, read, found = T * D, 0, 0, []
    while read < n:
        can_fill = fill < n and (
            model["empty_parity"][fill] < 0
            or (empty[model["producer_slot"][fill]] & 1)
            != model["empty_parity"][fill])
        can_read = read < fill and (
            (full[model["consumer_slot"][read]] & 1)
            != model["full_parity"][read])
        assert can_fill or can_read, "deadlock"
        if can_fill and (not can_read or rng.rand() < 0.5):
            k = model["producer_slot"][fill]
            slots[k] = fill
            full[k] += 1
            fill += 1
        else:
            k = model["consumer_slot"][read]
            found.append(slots[k])
            empty[k] += 1
            read += 1
    return model, found


@pytest.mark.parametrize("S", [2, 3, 4])
def test_stream_ring_slot_order(S):
    T, D = 3, 5
    model = ring_model(T, D, S)
    s = np.arange(T * D)
    assert np.array_equal(model["producer_slot"], s % S)
    assert np.array_equal(model["consumer_slot"], s % S)
    assert np.array_equal(model["full_parity"], (s // S) & 1)
    # stage s waits for the release of stage s - S, the slot's last tenant
    late = s >= S
    assert np.array_equal(model["empty_parity"][late],
                          ((s[late] - S) // S) & 1)
    assert np.all(model["empty_parity"][~late] == -1)
    for seed in range(20):
        _, found = simulate_ring(T, D, S, seed)
        assert found == list(range(T * D))   # each stage read, in its slot


@pytest.mark.parametrize("n,offset", [(pem.N, 0), (pem.N + 3, 0),
                                      (pem.N - 1, 1), (1000, 0), (7, 0)],
                         ids=["probe", "tail3", "offset_view", "small",
                              "tail_only"])
def test_p1_split_covers_each_index_once(n, offset):
    base = torch.zeros(n + offset)
    view = base[offset:]
    n4 = pem.vector_count(n, view, base[:n])
    assert n4 == (0 if offset else n // 4)
    for sms in (1, 132):
        blocks = p1_blocks(n, n4, sms)
        assert 1 <= blocks <= sms * P1_BLOCKS_PER_SM
        order = element_order(n, n4, blocks)
        assert len(order) == n
        assert np.array_equal(np.sort(order), np.arange(n))


def test_p1_offset_view_on_cpu_is_the_plain_version():
    a, b, c = (torch.from_numpy(v) for v in pem.probe_inputs()[:3])
    got = pem.fma_probe(a[1:], b[1:], c[1:])
    assert torch.equal(got, pem.fma_plain(a[1:], b[1:], c[1:]))


def test_floor_labels_cover_every_layout():
    labels = ps.floor_labels()
    kws = dict(ps.VARIANTS)
    assert {kws[lab].get("weights", "l2") for lab in labels} == {
        "l2", "stream", "cluster"}
    for lab in labels:
        kw = kws[lab]
        assert kw.get("precision", "exact") == "exact" and kw.get("gate", True)
        assert kw.get("D", ps.D_DEFAULT) == 43 and kw.get("B", 16) == 16
    fake = {lab: 1000.0 + i for i, lab in enumerate(labels)}
    fake["fast + gate (the TPU probe's DEFAULT)"] = 1.0   # not a floor
    assert ps.stage_floor(fake) == (labels[0], 1000.0)
