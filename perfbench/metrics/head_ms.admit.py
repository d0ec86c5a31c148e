"""head_ms.admit: device time of the fused head (``prod_head`` kernels) per
batch, over the traced batches (one quantiles call each)."""

from harness import profile


def read(run):
    if run.kind != "admit" or not run.trace:
        return None
    spent, n = profile.kernel_s(run.trace, "prod_head")
    if not n:
        return None
    return 1e3 * spent / len(run.trace["what"])
