"""decode_roofline.collect: the traced decode steps' attention calls (one a
layer), the valid K/V, q and o at the memory rate, over the device time of
the ``decode_fwd`` kernels, in %."""

from harness import profile


def read(run):
    if run.kind != "collect" or not run.trace:
        return None
    spent, n = profile.kernel_s(run.trace, "decode_fwd")
    if not n:
        return None
    w = run.trace["what"]
    nbytes = sum(run.md["n_layers"] * run.flops.decode_attn_bytes(run.md, w["rows"], k)
                 for k in w["keys"])
    return 100.0 * nbytes / run.peaks["hbm_bytes_per_s"] / spent
