"""flash_roofline.admit: the traced batches' prefill flash calls (one a
layer), their least time (the real queries' pairs over valid keys at the
bf16 peak, or q/k/v/o of the real tokens once at the memory rate, whichever
is longer), over the device time of the ``flash_fwd`` kernels, in %."""

from harness import profile


def read(run):
    if run.kind != "admit" or not run.trace:
        return None
    spent, n = profile.kernel_s(run.trace, "flash_fwd")
    if not n:
        return None
    least = sum(run.md["n_layers"] * run.flops.flash_least_s(run.md, u["lens"], run.peaks)
                for u in run.trace["what"])
    return 100.0 * least / spent
