"""moe_slot_ratio.admit: expert-product rows a MoE layer computes (experts x
capacity) over the (token, expert) pairs its real tokens route, summed over
the traced batches' MoE calls (read from ``models/moe.py::_dispatch``)."""


def read(run):
    if run.kind != "admit" or not run.trace or not run.trace.get("routing"):
        return None
    calls = run.trace["routing"]
    per_batch = len(calls) // len(run.trace["what"])
    slots = sum(c["E"] * c["cap"] for c in calls)
    pairs = sum(per_batch * sum(u["lens"]) * calls[0]["k"] for u in run.trace["what"])
    return slots / pairs
