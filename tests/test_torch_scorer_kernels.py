"""The scorer's redesigned kernels on the CPU: the plain versions of K7's
fused entries (`ordered_gate`, `ordered_res_skip`) against the separate
steps the scorer ran before they were fused and against the JAX scorer's
gate, the wrappers' routing and checks, and K0c's instance choice with a
numpy model of the warp instance's prefix sum (one shuffle a register for
offsets below 32, a lane's own registers above) against the fixed tree.

The kernels themselves run only on a card (`chip_smoke.py` phase 4 holds
each against these plain versions bit for bit).  Tolerances: the port
against its own earlier composition bit for bit (the same rounded
operations in the same order); against the JAX gate 2e-6 absolute (XLA's
products sum in another order, and its exact math contracts on the CPU,
fault R1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nv_wavenet_tpu.ops import exact_math as jem
from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.models import params as tparams
from nv_wavenet_tpu_torch.ops import exact_math as tem
from nv_wavenet_tpu_torch.ops import ordered_matmul as tom
from nv_wavenet_tpu_torch.ops import scan_generate as tsg
from nv_wavenet_tpu_torch.ops import score_parallel as tsp


def bits(t) -> np.ndarray:
    return np.asarray(t, dtype=np.float32).view(np.int32)


def gate_case(T, B, K, R, L=3, seed=0, bf16=False):
    """x_{t-d}, x_t, w_prev, w_cur, the [T, L, B, 2R] conditioning and dil_b
    from a seed; under bf16 the operands rounded to bf16 as the scorer's
    `op` and `product_view` round them."""
    rng = np.random.RandomState(seed)
    t = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
         for s in ((T * B, K), (T * B, K), (K, 2 * R), (K, 2 * R),
                   (T, L, B, 2 * R), (2 * R,))]
    if bf16:
        t[:4] = [tsg.round_bf16(v) for v in t[:4]]
    return t


def unfused_gate(xp, x, wp, wc, cond_l, bias, T, B, R):
    """The scorer's dilated layer unfused: two products, the adds,
    tanh and sigmoid of contiguous halves, the product."""
    zb = cond_l if bias is None else bias + cond_l
    z = (tom.ordered_matmul(xp, wp) + tom.ordered_matmul(x, wc)).reshape(
        T, B, 2 * R) + zb
    return (tem.exact_fn("tanh", z[..., :R].contiguous())
            * tem.exact_fn("sigmoid", z[..., R:].contiguous())).reshape(
                T * B, R)


@pytest.mark.parametrize("T,B,R,bias,bf16", [
    (35, 2, 36, True, False),     # M = 70, R of tests/test_torch_fused.py
    (25, 8, 64, False, False),    # M = 200, the flagship's R, prefolded
    (13, 3, 64, True, True),      # M = 39, bf16-rounded operands
])
def test_ordered_gate_plain_is_the_scorers_steps(T, B, R, bias, bf16):
    xp, x, wp, wc, cond, b = gate_case(T, B, R, R, seed=T + R, bf16=bf16)
    b = b if bias else None
    want = unfused_gate(xp, x, wp, wc, cond[:, 1], b, T, B, R)
    launches = (tom.ORDERED_GATE_KERNEL.launches,
                tom.ORDERED_MATMUL_KERNEL.launches)
    h = tom.ordered_gate(xp, x, wp, wc, cond[:, 1], b)     # strided zb
    assert launches == (tom.ORDERED_GATE_KERNEL.launches,
                        tom.ORDERED_MATMUL_KERNEL.launches)   # CPU: plain
    assert np.array_equal(bits(h), bits(want))
    flat = cond[:, 1].reshape(T * B, 2 * R)                # [M, 2R] zb
    assert np.array_equal(bits(tom.ordered_gate_plain(xp, x, wp, wc, flat,
                                                      b)), bits(want))
    # the JAX scorer's gate (`ops/score_parallel.py:134-148`) on the same
    # numpy inputs
    f = [np.asarray(v) for v in (xp, x, wp, wc, cond[:, 1])]
    z = (np.asarray(jnp.dot(f[0], f[2], precision="highest"))
         + np.asarray(jnp.dot(f[1], f[3], precision="highest"))).reshape(
             T, B, 2 * R)
    z = z + (f[4] if b is None else (np.asarray(b) + f[4]))
    hj = np.asarray(jem.tanh(jnp.asarray(z[..., :R]))
                    * jem.sigmoid(jnp.asarray(z[..., R:]))).reshape(T * B, R)
    np.testing.assert_allclose(h.numpy(), hj, atol=2e-6, rtol=0)


@pytest.mark.parametrize("round_x", [False, True])
def test_ordered_res_skip_plain_is_the_scorers_steps(round_x):
    rng = np.random.RandomState(3 + round_x)
    M, R, S = 70, 36, 40
    h, w, b, x, skip = (torch.from_numpy(rng.uniform(-1, 1, s).astype(
        np.float32)) for s in ((M, R), (R, R + S), (R + S,), (M, R), (M, S)))
    rs = tom.ordered_matmul(h, w)
    want_x = (rs[:, :R] + b[:R]) + x
    if round_x:
        want_x = tsg.round_bf16(want_x)
    want_skip = (skip + rs[:, R:]) + b[R:]
    launches = tom.ORDERED_RES_SKIP_KERNEL.launches
    x_out = tom.ordered_res_skip(h, w, b, x, skip, round_x=round_x)
    assert tom.ORDERED_RES_SKIP_KERNEL.launches == launches
    assert np.array_equal(bits(x_out), bits(want_x))
    assert np.array_equal(bits(skip), bits(want_skip))     # in place


def test_fused_wrappers_reject_bad_inputs():
    xp, x, wp, wc, cond, b = gate_case(4, 2, 8, 8)
    zb = cond[:, 0]
    with pytest.raises(ValueError, match="shapes"):
        tom.ordered_gate(xp[:-1], x, wp, wc, zb)
    with pytest.raises(ValueError, match="shapes"):
        tom.ordered_gate(xp, x, wp[:, :-1], wc[:, :-1], zb)
    with pytest.raises(ValueError, match="zb"):
        tom.ordered_gate(xp, x, wp, wc, zb[:-1])
    with pytest.raises(ValueError, match="unit stride"):
        tom.ordered_gate(xp, x, wp, wc, torch.zeros(4, 2, 32)[..., ::2])
    with pytest.raises(ValueError, match="bias"):
        tom.ordered_gate(xp, x, wp, wc, zb, b[:-1])
    with pytest.raises(ValueError, match="float32"):
        tom.ordered_gate(xp.double(), x, wp, wc, zb)
    with pytest.raises(ValueError, match="unsupported device"):
        tom.ordered_gate(*(t.to("meta") for t in (xp, x, wp, wc, zb)))
    h, w, bb, xr, sk = (torch.zeros(s) for s in ((5, 8), (8, 20), (20,),
                                                   (5, 8), (5, 12)))
    with pytest.raises(ValueError, match="shapes"):
        tom.ordered_res_skip(h, w, bb, xr, sk[:, :-1])
    with pytest.raises(ValueError, match="b: expected"):
        tom.ordered_res_skip(h, w, bb[:-1], xr, sk)
    with pytest.raises(ValueError, match="float32"):
        tom.ordered_res_skip(h, w.double(), bb, xr, sk)


def warp_prefix_sum(e: np.ndarray) -> np.ndarray:
    """exact_math_kernels.cu's warp_row_cumsum in numpy (the scan of K0c's
    softmax_p_warp_kernel and K0b's sample_warp_kernel): element
    i = r * 32 + lane in register r; a round of offset k < 32 shuffles each
    register from lane (lane - k) mod 32 (register r - 1 for the lanes
    below k), an offset 32 q adds register r - q of the same lane."""
    NR = e.shape[0] // 32
    c = e.reshape(NR, 32).copy()
    lanes = np.arange(32)
    k = 1
    while k < e.shape[0]:
        for r in range(NR - 1, -1, -1):
            if k < 32:
                send = np.where(lanes < 32 - k, c[r],
                                c[r - 1] if r else np.float32(0))
                t = send[(lanes - k) & 31]
                add = np.where((r > 0) | (lanes >= k), t, np.float32(0))
            else:
                add = c[r - k // 32] if r >= k // 32 else np.float32(0)
            c[r] = c[r] + add.astype(np.float32)
        k *= 2
    return c.reshape(-1)


@pytest.mark.parametrize("A", [32, 96, 256, 1024])
def test_k0c_warp_scan_pairs_the_fixed_tree(A):
    rng = np.random.RandomState(A)
    e = (rng.uniform(0, 1, A) * rng.uniform(0, 4, A)).astype(np.float32)
    want = tem.fixed_tree_cumsum(torch.from_numpy(e)).numpy()
    assert np.array_equal(bits(warp_prefix_sum(e)), bits(want))


def test_k0c_instance_by_width():
    assert all(tem.softmax_kernel(A) is tem.SOFTMAX_KERNEL
               for A in (32, 64, 96, 256, 1024))
    assert all(tem.softmax_kernel(A) is tem.SOFTMAX_BLOCK_KERNEL
               for A in (1, 16, 250, 257, 1056, 2048))
    assert tem.SOFTMAX_KERNEL.symbol != tem.SOFTMAX_BLOCK_KERNEL.symbol
    za = torch.from_numpy(np.random.RandomState(5).uniform(
        -8, 8, (6, 250)).astype(np.float32))
    launches = (tem.SOFTMAX_KERNEL.launches, tem.SOFTMAX_BLOCK_KERNEL.launches)
    p = tem.softmax_canonical(za)
    assert launches == (tem.SOFTMAX_KERNEL.launches,
                        tem.SOFTMAX_BLOCK_KERNEL.launches)
    assert np.array_equal(bits(p), bits(tem.softmax_canonical_plain(za)))


def test_scorer_pass_goes_through_the_fused_entries(monkeypatch):
    """One scorer pass calls the gate and the res/skip entry once a layer
    and the plain product twice (out, end): on the card, 2 L + 2 K7
    launches in place of the unfused scorer's 3 L + 2."""
    cfg = WaveNetConfig(num_layers=3, R=8, S=16, A=256, max_dilation=2)
    calls = {"ordered_gate": 0, "ordered_res_skip": 0, "ordered_matmul": 0}
    for name in calls:
        def counted(*a, _f=getattr(tsp, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(tsp, name, counted)
    rng = np.random.RandomState(0)
    B, T = 2, 5
    params = tparams.canonical_to_torch(tparams.to_canonical(
        tparams.random_reference_weights(cfg, seed=1), cfg), "cpu")
    cond = torch.from_numpy(rng.uniform(-1, 1, (T, 3, B, 16)).astype(
        np.float32))
    y = torch.from_numpy(rng.randint(0, 256, (T, B)).astype(np.int32))
    ring = torch.zeros((cfg.ring_size, B, cfg.R))
    ys = torch.full((2, B), cfg.silence_bin, dtype=torch.int32)
    p = tsp.make_parallel_scorer(cfg, B)(params, 0, cond, y, ring, ys)[0]
    assert calls == {"ordered_gate": 3, "ordered_res_skip": 3,
                     "ordered_matmul": 2}
    assert p.shape == (T, B, 256) and torch.isfinite(p).all()


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::ordered_kernel<128, 64, 8, 8, 1>(Args)",
     "K7 gate"),
    ("_ZN12_GLOBAL__N_114ordered_kernelILi128ELi64ELi8ELi8ELi2EEEv4Args",
     "K7 res/skip"),
    ("void (anonymous namespace)::ordered_kernel<128, 128, 8, 8, 0>(Args)",
     "K7 product"),
    ("ordered_matmul_kernel", "K7 product"),
    ("exact_fn_kernel(float const*, float*, long long, int)", "K0a"),
    ("void (anonymous namespace)::softmax_p_warp_kernel<8>(float const*, "
     "float*, int)", "K0c"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>",
     "torch (elementwise, gathers, copies)")])
def test_scorer_split_groups_kernels_by_name(name, group):
    """The scorer split (`tools/scorer_ab.kernel_group`) files each device
    kernel under its group: K7's entries by their mode, the last template
    argument, in demangled and mangled names."""
    from nv_wavenet_tpu_torch.tools import scorer_ab
    assert scorer_ab.kernel_group(name) == group
