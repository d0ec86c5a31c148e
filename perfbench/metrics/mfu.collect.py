"""mfu.collect: the window's least time over its wall, in %. A call's least
time is its prefill's FLOPs needed at the bf16 peak, each distinct prompt
once (the call tiles each prompt over ``repeats`` rows; its inputs need one
prefill of it), plus, for each decode step, the larger of its FLOPs at the
peak and its bytes at the memory rate: each weight once (a MoE layer: the
experts the traced steps routed to, on average), the output head once, the
embedding rows and the valid K/V."""


def read(run):
    if run.kind != "collect":
        return None
    md, fl, pk = run.md, run.flops, run.peaks
    experts = None
    if md["family"] == "moe":
        calls = (run.trace or {}).get("routing")
        if not calls:
            return None
        experts = sum(c["experts_routed"] for c in calls) / len(calls)
    least = 0.0
    for u in run.units:
        lens, rows = u["lens"], u["rows"]
        least += fl.prefill_flops(md, lens[::run.mix["repeats"]]) / pk["bf16_flops"]
        for t in range(u["max_new"]):
            keys = sum(lens) + rows * (t + 1)
            least += fl.least_s(fl.step_flops(md, rows, keys),
                                fl.step_bytes(md, rows, keys, experts), pk)
    return 100.0 * least / (run.t1 - run.t0)
