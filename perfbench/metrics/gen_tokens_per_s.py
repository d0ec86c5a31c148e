"""gen_tokens_per_s: tokens generated by the window's generation calls, over
the time from the window's start to the last call's end (host clock)."""


def read(run):
    if run.kind != "collect":
        return None
    return sum(u["gen_tokens"] for u in run.units) / (run.t1 - run.t0)
