"""unembed_ms.collect: device time of the kernels and copies launched inside
the program's ``model.unembed`` span (the head cast to fp32 and the fp32
GEMM, ``models/layers.py::unembed``) a decode step, over the traced steps."""

from harness import spans


def read(run):
    if run.kind != "collect" or not run.trace:
        return None
    tr = spans.load(run)
    spent = tr.device_s_by_span().get("model.unembed") if tr else None
    if not spent:
        return None
    return 1e3 * spent / run.trace["what"]["steps"]
