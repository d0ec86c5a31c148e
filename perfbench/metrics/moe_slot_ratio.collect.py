"""moe_slot_ratio.collect: expert-product rows a MoE layer computes (experts x
capacity) over the (token, expert) pairs routed, summed over the traced
decode steps' MoE calls (read from ``models/moe.py::_dispatch``)."""


def read(run):
    if run.kind != "collect" or not run.trace or not run.trace.get("routing"):
        return None
    calls = run.trace["routing"]
    return sum(c["E"] * c["cap"] for c in calls) / sum(c["T"] * c["k"] for c in calls)
