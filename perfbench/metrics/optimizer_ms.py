"""optimizer_ms: device time of the operations launched inside the
program's ``train_step.optimizer`` range (AdamW), per step of the traced
window, in ms. Device trace."""

RANGE = "train_step.optimizer"


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    steps = run.trace.range_count(RANGE)
    ops = run.trace.ops_launched_in(RANGE)
    if not steps or not ops:
        return None
    return sum(b - a for _, a, b, _ in ops) / 1e3 / steps
