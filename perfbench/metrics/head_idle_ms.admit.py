"""head_idle_ms.admit: device-idle time inside the program's ``head.quantiles``
spans (``LengthPredictor.quantiles``: the span's host interval less the union
of device intervals), a batch, over the traced batches."""

from harness import spans


def read(run):
    if run.kind != "admit" or not run.trace:
        return None
    tr = spans.load(run)
    if tr is None or not tr.device or not tr.intervals("head.quantiles"):
        return None
    return 1e3 * tr.idle_inside("head.quantiles") / len(run.trace["what"])
