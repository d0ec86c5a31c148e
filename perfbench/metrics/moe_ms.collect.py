"""moe_ms.collect: device time of the kernels and copies launched inside the
program's ``moe.*`` spans (router, dispatch, expert products, combine of
``models/moe.py``) a decode step, over the traced steps."""

from harness import spans


def read(run):
    if run.kind != "collect" or not run.trace:
        return None
    tr = spans.load(run)
    spent = sum(s for name, s in tr.device_s_by_span().items()
                if name.startswith("moe.")) if tr else 0.0
    if not spent:
        return None
    return 1e3 * spent / run.trace["what"]["steps"]
