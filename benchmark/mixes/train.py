"""Traffic kind "train": `trainer.train_step` in a loop over the batches of
the program's own pipeline, on one process a card.

Set-up builds one training state (`trainer.create_model`,
`create_train_state`; under several processes DDP over a data-parallel
mesh on NCCL), loads the initial parameters the benchmark draws from the
seed, and feeds it `Mel2Samp.batches` over raw clips drawn from the seed,
featurised on the host and staged by the trainer's device prefetch.  The
first `checked_steps` steps go through that same call and feed; their
losses, the first gradient as Adam holds it (its first moment after one
step over 1 - b1) and the parameters' change after them are kept for the
check.  After `warmup_steps` more the window steps that same state until
`--seconds` have passed.  No checkpoint is written.

Across processes the window ends on the same step everywhere: every
`stop_every` steps the ranks take the max of a stop flag.

The check (rank 0, after the window): the plain reference
(`reference/train_ref.py`) runs the checked steps on the same initial
parameters and raw clips, the segments drawn as the pipeline draws them,
and every rank's readings are held against it leaf by leaf.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import train_ref
from benchmark.tracing import span, sync

B1 = 0.9   # Adam's first-moment decay, the trainer's (optax's default)


def _data_cfg(run):
    from nv_wavenet_tpu_torch.train.data import data_config_from_json
    return data_config_from_json(run.cfg["data_config"])


def setup(run) -> dict:
    from nv_wavenet_tpu_torch.train import trainer
    from nv_wavenet_tpu_torch.train.data import Mel2Samp
    t, c = run.traffic, run.cfg
    if t["data_parallel"] != run.world:
        raise ValueError(f"traffic for {t['data_parallel']} data ranks on "
                         f"{run.world} process(es)")
    w = dict(c["wavenet_config"], **run.engine_kw)
    model = trainer.create_model(w)
    tc = c["train_config"]
    tcfg = trainer.TrainConfig(learning_rate=tc["learning_rate"],
                               batch_size=tc["batch_size"], seed=tc["seed"])
    state = trainer.create_train_state(model, tcfg, run.device)
    p0 = inputs.train_params(c["wavenet_config"], run.seed, run.device)
    state.module.load_state_dict(p0)
    d = c["data_config"]
    clips = inputs.audio_clips(run.seed, t["clips"], t["clip_samples"],
                               d["sampling_rate"])
    ds = Mel2Samp(clips, _data_cfg(run), seed=inputs.data_seed(run.seed))
    batches = trainer._device_prefetch(
        ds.batches(tcfg.batch_size, rank=run.rank, world_size=run.world),
        run.device)
    st = {"trainer": trainer, "state": state, "batches": batches,
          "losses": [], "names": [n for n, _ in
                                  state.module.named_parameters()]}
    params = dict(state.module.named_parameters())
    for i in range(t["checked_steps"]):
        mel, audio = next(batches)
        st["losses"].append(float(trainer.train_step(state, mel, audio)))
        if i == 0:
            opt = state.optimizer.state
            st["grad1"] = [float(torch.linalg.vector_norm(
                opt[params[n]]["exp_avg"]) / (1 - B1)) for n in st["names"]]
    with torch.no_grad():
        st["change"] = [float(torch.linalg.vector_norm(params[n] - p0[n]))
                        for n in st["names"]]
    del p0
    for _ in range(t["warmup_steps"]):
        mel, audio = next(batches)
        trainer.train_step(state, mel, audio)
    sync(run.device)
    return st


def _stop(run, elapsed: float, step: int) -> bool:
    """The window ends: on this rank's clock in one process; across
    processes, every `stop_every` steps, where any rank's clock says so."""
    if run.world == 1:
        return elapsed >= run.seconds
    if step % run.traffic["stop_every"]:
        return False
    import torch.distributed as dist
    flag = torch.tensor([float(elapsed >= run.seconds)], device=run.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def _barrier(run) -> None:
    sync(run.device)
    if run.world > 1:
        import torch.distributed as dist
        dist.barrier(device_ids=[run.device.index]
                     if run.device.type == "cuda" else None)
        sync(run.device)


def window(run, st: dict) -> None:
    trainer, state, batches = st["trainer"], st["state"], st["batches"]
    fetch_s, steps = [], 0
    _barrier(run)
    run.open_window()
    while True:
        a = time.perf_counter()
        with span("fetch"):
            mel, audio = next(batches)
        fetch_s.append(time.perf_counter() - a)
        with span("step"):
            trainer.train_step(state, mel, audio)
        steps += 1
        if _stop(run, run.unit_done(), steps):
            break
    _barrier(run)
    run.close_window()
    run.spans["fetch"] = fetch_s
    run.counts.update(steps=steps, clips_per_step=run.cfg["train_config"]
                      ["batch_size"] * run.world,
                      segment=run.cfg["data_config"]["segment_length"])
    run.attempted = steps


def release(run, st: dict) -> None:
    batches = st.pop("batches", None)
    if batches is not None:
        batches.close()
    st.pop("state", None)


def readings(st: dict) -> dict:
    """What a rank hands to the check."""
    return {"losses": st["losses"], "grad1": st["grad1"],
            "change": st["change"], "names": st["names"]}


def reference(run) -> dict:
    """The reference's readings of the checked steps over all data ranks."""
    t, c = run.traffic, run.cfg
    w, d = c["wavenet_config"], c["data_config"]
    clips = inputs.audio_clips(run.seed, t["clips"], t["clip_samples"],
                               d["sampling_rate"])
    streams = [train_ref.batches(clips, d, inputs.data_seed(run.seed),
                                 c["train_config"]["batch_size"], r,
                                 run.world) for r in range(run.world)]
    steps = []
    for _ in range(t["checked_steps"]):
        parts = []
        for s in streams:
            mel, bins = next(s)
            parts.append((torch.as_tensor(mel, device=run.device),
                          torch.as_tensor(bins, device=run.device)))
        steps.append(parts)
    p0 = inputs.train_params(w, run.seed, run.device)
    ref = train_ref.reference_steps(p0, w, c["train_config"]["learning_rate"],
                                    steps)
    names = list(p0)
    return {"names": names, "losses": ref["losses"],
            "grad1": [float(torch.linalg.vector_norm(ref["grad1"][n]))
                      for n in names],
            "change": [float(torch.linalg.vector_norm(ref["params"][n]
                                                      - p0[n]))
                       for n in names]}


def gaps(got: dict, ref: dict) -> dict:
    """The compared numbers of one rank: the relative gap of the first
    step's loss; of a leaf's first-gradient norm and of its change over the
    checked steps, the widest over the leaves, each against the larger of
    the reference's norm of that leaf and of the median leaf.  Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone under Adam and are left out of the change.  The later
    steps' loss gaps and the widest leaves are kept beside them."""
    if sorted(got["names"]) != sorted(ref["names"]):
        raise ValueError("the program's parameters are not the reference's: "
                         f"{sorted(set(got['names']) ^ set(ref['names']))}")
    order = [got["names"].index(n) for n in ref["names"]]
    g_got = np.array([got["grad1"][i] for i in order])
    c_got = np.array([got["change"][i] for i in order])
    loss = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                 ref["losses"])]
    g_ref, c_ref = np.array(ref["grad1"]), np.array(ref["change"])
    g_med, c_med = np.median(g_ref), np.median(c_ref)
    grad = np.abs(g_got - g_ref) / np.maximum(g_ref, g_med)
    moved = g_ref >= 1e-3 * g_med
    change = np.where(moved, np.abs(c_got - c_ref) / np.maximum(c_ref, c_med),
                      0.0)
    return {"loss1_gap": float(loss[0]), "grad1_gap": float(grad.max()),
            "change_gap": float(change.max()),
            "loss_gaps": loss,
            "grad1_leaf": ref["names"][int(grad.argmax())],
            "change_leaf": ref["names"][int(change.argmax())],
            "change_median_gap": float(np.median(change[moved])),
            "leaves_left_out": int((~moved).sum())}


def check(run, st: dict) -> None:
    ref = reference(run)
    per_rank = [readings(st)] + [w["readings"] for w in run.worker_results]
    worst = {"loss1_gap": 0.0, "grad1_gap": 0.0, "change_gap": 0.0}
    for r, got in enumerate(per_rank):
        g = gaps(got, ref)
        run.notes[f"rank{r}"] = g
        for k in worst:
            worst[k] = max(worst[k], g[k])
    lim = run.traffic["limits"]
    for k, v in worst.items():
        run.compare(k, v, lim[k])
    run.notes["reference_losses"] = ref["losses"]
