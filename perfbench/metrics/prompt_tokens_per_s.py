"""prompt_tokens_per_s: real (unpadded) prompt tokens prefilled and predicted,
over the window (host clock)."""


def read(run):
    if run.kind != "admit":
        return None
    return sum(sum(u["lens"]) for u in run.units) / (run.t1 - run.t0)
