"""moe_drop_share.admit: the (token, expert) pairs that the MoE layers'
capacity dispatch dropped over the pairs routed, from the program's counters
``moe.dropped`` and ``moe.pairs`` over the traced batches' prefills (padding
positions route too, as the dispatch sees them)."""

from harness import spans


def read(run):
    return spans.moe_drop_share(run, "admit")
