"""decode_attn_ms: device time of the decode-attention kernel's functions
(``decode_attn_mma`` or ``decode_attn_fma``, and ``decode_attn_merge``,
which merges their splits) launched inside the engine's ``engine.decode``
spans, per span, in ms: one launch of each a layer a decode step. Device
trace, placed by launch, the functions found by name. Nothing is read
where the trace has no such span or no such function launched in one (a
program whose decode attention is plain PyTorch)."""

SPAN, NAME = "engine.decode", "decode_attn_"


def read(run):
    trace = getattr(run, "trace", None)
    if trace is None:
        return None
    n = trace.range_count(SPAN)
    ops = [o for o in trace.ops_launched_in(SPAN) if NAME in o[0]]
    if not n or not ops:
        return None
    return sum(b - a for _, a, b, _ in ops) / 1e3 / n
