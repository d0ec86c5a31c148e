"""idle_share.collect: the share of the traced window in which no kernel, copy or
set ran on the device, in % (the union of device intervals from the trace)."""


def read(run):
    if run.kind != "collect" or not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
