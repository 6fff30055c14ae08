"""Sharded generation of the port across two processes: one spawned pair
joined by `parallel/mesh.initialize_multihost` on gloo at 127.0.0.1, each
holding two CPU shards of a global batch of 8 (the 'data' axis spans 4).
Each process passes only its own rows to `set_inputs` / `feed` and reads
only its own back; its default selectors are `_selector_stream(...,
pidx=rank)`, the local row index with the process's.  Assembled, the rows
equal the single-process engine and the numpy golden model given the same
selectors explicitly, and the port's `_selector_stream` equals the JAX
engine's bit for bit at pidx 0 and 1.

The worker is this file's __main__; it imports the port only."""

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC, BG, T, SEED = 2, 8, 10, 3
GEOMETRY = dict(num_layers=4, R=32, S=64, A=256, max_dilation=4)


def inputs():
    """The global conditioning [T, L, BG, 2R] every process draws alike."""
    rng = np.random.RandomState(5)
    return rng.uniform(-0.5, 0.5, (T, GEOMETRY["num_layers"], BG,
                                   2 * GEOMETRY["R"])).astype(np.float32)


def _worker(rank: int, port: int, out_dir: str):
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    from nv_wavenet_tpu_torch.config import WaveNetConfig
    from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
    from nv_wavenet_tpu_torch.models import params as tparams
    from nv_wavenet_tpu_torch.parallel import mesh as tmesh

    tmesh.initialize_multihost(f"127.0.0.1:{port}", NPROC, rank,
                               device="cpu")
    mesh = tmesh.data_mesh(devices=[torch.device("cpu")] * 2)
    assert mesh.shape["data"] == 2 * NPROC and mesh.process_index == rank
    assert [s.index for s in mesh.shards] == [2 * rank, 2 * rank + 1]
    ref_w = tparams.random_reference_weights(WaveNetConfig(**GEOMETRY),
                                             seed=11)
    bl = BG // NPROC
    cond = inputs()[:, :, rank * bl:(rank + 1) * bl]
    eng = WaveNetInfer(**GEOMETRY, max_batch=BG, chunk_size=4, mesh=mesh)
    eng.set_reference_weights(ref_w)
    eng.sampling_seed = SEED
    eng.set_inputs(cond)                     # this process's rows only
    y = eng.run(T, BG)                       # batch_size stays global
    assert y.shape == (bl, T)
    eng.begin_stream(BG)
    fed = np.concatenate([eng.feed(cond[:6]), eng.feed(cond[6:])], axis=1)
    assert np.array_equal(fed, y), "feed != run under the default stream"
    snap = eng.export_state()
    assert snap["y_state"].shape == (2, bl)
    np.save(os.path.join(out_dir, f"y{rank}.npy"), y)
    print(f"WORKER {rank} GENERATION_OK", flush=True)


def test_two_processes_generate_their_own_rows(tmp_path):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(port),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for rank in range(NPROC)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-3000:]}"
        assert f"WORKER {rank} GENERATION_OK" in out

    from nv_wavenet_tpu.config import WaveNetConfig
    from nv_wavenet_tpu.engine import wavenet_infer as jinfer
    from nv_wavenet_tpu.models import params as params_lib
    from nv_wavenet_tpu.models.golden import WaveNetGolden
    from nv_wavenet_tpu_torch.engine import wavenet_infer as tinfer

    bl = BG // NPROC
    # the selectors each process drew: its local rows keyed on its index,
    # the port's stream bit for bit the JAX engine's (also per-row clocks)
    sel = []
    for pidx in range(NPROC):
        mine = tinfer._selector_stream(SEED, 0, T, bl, pidx)
        assert np.array_equal(mine, jinfer._selector_stream(SEED, 0, T, bl,
                                                            pidx))
        sel.append(mine)
    clocks = np.array([0, 5, 9, 2])
    assert np.array_equal(tinfer._selector_stream(SEED, clocks, T, 4, 1),
                          jinfer._selector_stream(SEED, clocks, T, 4, 1))
    sel = np.concatenate(sel, axis=1)
    y = np.concatenate([np.load(tmp_path / f"y{r}.npy")
                        for r in range(NPROC)], axis=0)

    cfg = WaveNetConfig(**GEOMETRY)
    ref_w = params_lib.random_reference_weights(cfg, seed=11)
    cond = inputs()
    single = tinfer.WaveNetInfer(**GEOMETRY, max_batch=BG, chunk_size=4,
                                 device="cpu")
    single.set_reference_weights(ref_w)
    single.set_inputs(cond, sel)
    assert np.array_equal(y, single.run(T, BG))
    golden = WaveNetGolden(cfg, BG, T)
    golden.set_reference_weights(ref_w)
    golden.set_inputs(cond, sel)
    assert int((y != golden.run(T, BG)).sum()) == 0


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
