"""train_mfu: the frozen model FLOPs of a train step (``flops.train_flops``)
times the steps of the window, over the window's seconds at the card's
dense bf16 peak, in %. Host clock."""
from perfbench import flops, peaks


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    t0, t1 = run.window
    work = flops.train_flops(run.cfg, run.mix["batch"],
                             run.mix["seq"])["flops"] * len(run.steps)
    return 100.0 * work / ((t1 - t0) * peaks.BF16_FLOPS)
