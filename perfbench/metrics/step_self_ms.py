"""step_self_ms: the time of the engine's step() outside its prefills
(decode, the lane scatter, admission's bookkeeping), over the steps of
the traced window, in ms. Host clock."""


def read(run):
    spans = getattr(run, "prefills", None)
    if run.kind != "serve" or run.trace is None or not run.steps:
        return None
    total = sum(b - a for a, b in run.steps)
    inside = sum(b - a for a, b, _ in spans or ())
    return (total - inside) * 1e3 / len(run.steps)
