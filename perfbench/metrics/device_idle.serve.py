"""device_idle.serve: the share of the traced window in which no device
operation ran (1 - the union of kernel, copy and set intervals over the
window), in %, in a serving cell. Device trace."""


def read(run):
    if run.kind != "serve" or run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
