"""serve_tok_s: every token delivered to a client in the window (first
tokens and decoded ones) over the window's seconds. Host clock."""
from perfbench import stats


def read(run):
    if run.kind != "serve":
        return None
    t0, t1 = run.window
    return stats.rate(run.tokens, t1 - t0)
