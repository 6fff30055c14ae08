"""The port's probes on the CPU: P1 (`tools/probe_exact_math.py`) and P5
(`tools/probe_stage.py`), the plain versions of `csrc/probes.cu`, and P6's
bookkeeping (`tools/barrier_probe.py`: its cases and the count each form
leaves, which the tool checks after every launch on the card).

  * P5's plain version against the JAX probe's `make_chain` in interpret
    mode (B=2, R=8, D=3, T=2, gate on and off, groups 1 and 2): max abs
    1e-5.  The JAX probe's gate is jnp.tanh / jax.nn.sigmoid and its fp32
    products sum in XLA's order; the port's exact version takes K1's order
    and the canonical tanh and sigmoid, its fast version torch's: a few
    ulps of O(1) values either way.  The JAX probe is imported in a
    subprocess: its import sets the JAX compilation cache, process-global
    state, so the subprocess gets PROBE_INTERPRET=1 and a temporary
    NV_WAVENET_TPU_CACHE.
  * P1's plain version against numpy's separate a*b+c on the JAX probe's
    inputs: 0 bit mismatches (the JAX `kern_plain` has no interpret flag;
    numpy is the reference the JAX probe itself uses).
  * The wrappers: CPU tensors take the plain versions; shapes the kernels
    do not take raise; the measuring entry points fail without a card.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from nv_wavenet_tpu_torch.tools import barrier_probe as bp
from nv_wavenet_tpu_torch.tools import probe_exact_math as pem
from nv_wavenet_tpu_torch.tools import probe_stage as ps

REPO = pathlib.Path(__file__).resolve().parents[1]
B, R, D, T = 2, 8, 3, 2
CHAIN_CASES = [(gate, groups) for gate in (True, False) for groups in (1, 2)]

JAX_CHAIN = """
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tools")
import probe_stage
w = np.load(sys.argv[1] + "/w.npy")
x = np.load(sys.argv[1] + "/x.npy")
out = {}
for gate in (True, False):
    for groups in (1, 2):
        f = probe_stage.make_chain(%d, %d, %d, %d, jax.lax.Precision.HIGHEST,
                                   gate, groups)
        out[f"{gate}-{groups}"] = np.asarray(
            jax.jit(f)(w, x[:groups])).tolist()
print(json.dumps(out))
""" % (B, R, D, T)


def chain_inputs():
    rng = np.random.RandomState(3)
    w = rng.uniform(-0.15, 0.15, (D, R, 2 * R)).astype(np.float32)
    x = rng.uniform(-1, 1, (2, B, R)).astype(np.float32)
    return w, x


@pytest.fixture(scope="module")
def jax_chains(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("probe_stage")
    w, x = chain_inputs()
    np.save(tmp / "w.npy", w)
    np.save(tmp / "x.npy", x)
    env = dict(os.environ, PROBE_INTERPRET="1", JAX_PLATFORMS="cpu",
               NV_WAVENET_TPU_CACHE=str(tmp / "jax_cache"))
    out = subprocess.run([sys.executable, "-c", JAX_CHAIN, str(tmp)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return {k: np.asarray(v, np.float32) for k, v in res.items()}


@pytest.mark.parametrize("precision", ps.PRECISIONS)
@pytest.mark.parametrize("gate,groups", CHAIN_CASES)
def test_chain_plain_matches_jax_probe(jax_chains, gate, groups, precision):
    w, x = chain_inputs()
    got = ps.chain_plain(torch.from_numpy(w),
                         torch.from_numpy(x[:groups].copy()), T, gate,
                         precision).numpy()
    ref = jax_chains[f"{gate}-{groups}"]
    assert got.shape == ref.shape == (groups, B, R)
    assert float(np.abs(got - ref).max()) <= 1e-5


def test_make_chain_on_cpu_is_the_plain_version():
    w, x = (torch.from_numpy(v) for v in chain_inputs())
    for prec in ps.PRECISIONS:
        for weights in ps.WEIGHTS:
            run = ps.make_chain(B, R, D, T, prec, True, 2, B, weights)
            assert torch.equal(run(w, x), ps.chain_plain(w, x, T, True,
                                                         prec))


@pytest.mark.parametrize("kw", [
    dict(precision="highest"), dict(weights="vmem"), dict(rows=3),
    dict(B=16, R=64, D=7, weights="smem"),        # 229,376 bytes of W
    dict(B=128, R=128, rows=128, groups=2)],      # x and z past 227 KB
    ids=["precision", "weights", "rows", "smem_w", "smem_xz"])
def test_make_chain_rejects(kw):
    args = dict(B=B, R=R, D=D, T=T)
    args.update(kw)
    with pytest.raises(ValueError):
        ps.make_chain(**args)


def test_make_chain_checks_its_tensors():
    w, x = (torch.from_numpy(v) for v in chain_inputs())
    run = ps.make_chain(B, R, D, T, groups=1)
    with pytest.raises(ValueError, match="x"):
        run(w, x)                      # groups 2 given, 1 declared


def test_variants_are_runnable_shapes():
    """Every variant of the sweep builds (shared memory within a block)."""
    for _, kw in ps.VARIANTS:
        args = dict(B=ps.B_DEFAULT, R=ps.R_DEFAULT, D=ps.D_DEFAULT, T=1)
        args.update(kw)
        ps.make_chain(**args)


def test_fma_plain_equals_numpy_separate():
    a, b, c = pem.probe_inputs()[:3]
    sep, fma = pem.references(a, b, c)
    got = pem.fma_probe(*(torch.from_numpy(v) for v in (a, b, c)))
    assert pem.bit_mismatches(got.numpy(), sep) == 0
    # the inputs do tell separate from contracted rounding
    assert pem.bit_mismatches(sep, fma) > 0


def test_fma_probe_cpu_forms_and_checks():
    a, b, c = (torch.from_numpy(v) for v in pem.probe_inputs()[:3])
    for flags in pem.FMA_PROBE_KERNELS:
        for form in pem.FORMS:
            assert torch.equal(pem.fma_probe(a, b, c, form, flags),
                               pem.fma_plain(a, b, c))
    with pytest.raises(ValueError):
        pem.fma_probe(a, b, c, form="barrier")
    with pytest.raises(ValueError):
        pem.fma_probe(a, b[:7], c)


def test_probe_inputs_follow_the_jax_probe():
    """RandomState(0) in the JAX probe's order: the x sweep's ranges and
    the sampler's shapes."""
    a, b, c, x, za, sel = pem.probe_inputs()
    assert a.shape == b.shape == c.shape == x.shape == (pem.N,)
    assert np.abs(x[:pem.N // 2]).max() > 4
    assert np.abs(x[-pem.N // 4:]).max() < 0.6
    assert za.shape == (4096, 256) and sel.shape == (4096, 1)
    rng = np.random.RandomState(0)
    assert np.array_equal(a, rng.uniform(-2, 2, pem.N).astype(np.float32))


def test_measuring_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probes measure there")
    with pytest.raises(RuntimeError, match="CUDA"):
        ps.measure("x", T=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        pem.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        bp.measure("flat", 8, False, K=1)


@pytest.mark.parametrize("form, cluster, want", [
    ("flat", 8, 128 * 62), ("flat", 1, 128 * 62),
    ("two_level", 8, 16 * 62), ("two_level", 4, 32 * 62),
    ("two_level", 1, 128 * 62)])
def test_barrier_probe_counts_one_arrival_a_cluster(form, cluster, want):
    """The flat barrier's count takes every CTA's arrival, the two-level
    one's one a cluster: at K1 card-wide's 128 CTAs, 16 a barrier in
    clusters of 8."""
    assert bp.expected_count(form, 62, 128, cluster) == want


def test_barrier_probe_takes_k1_card_wides_cluster():
    """cluster_of's rule: the most CTAs (8 at most) that divide the grid
    and whose clusters the card holds all at once."""
    held = {8: 15, 4: 32, 2: 66, 1: 132}
    assert bp.cluster_sizes(128, held) == [4, 2, 1]
    assert bp.cluster_sizes(120, held) == [8, 4, 2, 1]
    assert bp.cluster_sizes(12, held) == [4, 2, 1]
    assert bp.cluster_sizes(131, held) == [1]
    with pytest.raises(ValueError, match="holds no grid"):
        bp.cluster_sizes(133, held)


def test_barrier_probe_cases():
    assert bp.cases([8, 4, 1]) == [
        ("flat", 8, False), ("flat", 8, True),
        ("two_level", 8, False), ("two_level", 8, True),
        ("two_level", 4, False), ("two_level", 4, True),
        ("two_level", 1, False), ("two_level", 1, True)]
    with pytest.raises(ValueError, match="form"):
        bp.expected_count("tree", 1, 8, 8)
