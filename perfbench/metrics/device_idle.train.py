"""device_idle.train: the share of the traced window in which no device
operation ran, in %, in a training cell. Device trace."""


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
