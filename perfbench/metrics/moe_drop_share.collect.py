"""moe_drop_share.collect: the (token, expert) pairs that the MoE layers'
capacity dispatch dropped over the pairs routed, from the program's counters
``moe.dropped`` and ``moe.pairs`` over the traced decode steps (padding
positions route too, as the dispatch sees them)."""

from harness import spans


def read(run):
    return spans.moe_drop_share(run, "collect")
