"""The training step's share of the cards' fp32 peak: 3 x the forward's
FLOPs from the shapes (`work.train_step_flops`, all ranks' clips) x steps
/ seconds / (67 TFLOP/s x cards), in %, over the window (in a traced run,
its part after the profiler stopped).  The fp32 peak applies: the
precision "highest" keeps TF32 off."""

from benchmark import work


def read(run):
    part = run.untraced()
    c = run.counts
    if part is None or not c.get("steps"):
        return None
    u, seconds = part
    d = run.cfg["data_config"]
    flops = work.train_step_flops(run.cfg["wavenet_config"],
                                  c["clips_per_step"], c["segment"],
                                  d["hop_length"])
    return (100.0 * flops * (c["steps"] - u) / seconds
            / (work.PEAK_FP32_FLOPS * run.world))
