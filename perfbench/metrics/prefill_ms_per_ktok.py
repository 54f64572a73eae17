"""prefill_ms_per_ktok: every prefill's time (its call to its end on the
device, timed by the traced run's proxy) over every prompt token in the
window, per thousand tokens. Host clock."""


def read(run):
    spans = getattr(run, "prefills", None)
    if not spans:
        return None
    seconds = sum(b - a for a, b, _ in spans)
    tokens = sum(s for _, _, s in spans)
    return seconds * 1e3 / tokens * 1e3
