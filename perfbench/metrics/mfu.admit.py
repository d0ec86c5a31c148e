"""mfu.admit: the FLOPs the window's batches need (the weight products of real
tokens, a MoE layer's k routed experts and router; the attention pairs of
real queries over valid keys; one unembedded row and the head per request),
over the window's wall time at the bf16 peak, in %."""


def read(run):
    if run.kind != "admit":
        return None
    hid, bins = run.init["head_hidden"], run.init["head_bins"]
    need = sum(run.flops.prefill_flops(run.md, u["lens"], hid, bins) for u in run.units)
    return 100.0 * need / ((run.t1 - run.t0) * run.peaks["bf16_flops"])
