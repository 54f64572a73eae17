"""train_tok_s: tokens of every train step completed in the window over
the window's seconds (the window closes at the first step boundary after
--seconds). Host clock."""
from perfbench import stats


def read(run):
    if run.kind != "train":
        return None
    t0, t1 = run.window
    return stats.rate(run.tokens, t1 - t0)
