"""mla_ms.admit: device time of the kernels and copies launched inside the
program's ``mla.*`` spans (``models/mla.py``'s latent attention: the q and
kv projections with their norms and rope, the flash call, the output
projection) a batch, over the traced batches."""

from harness import spans


def read(run):
    if run.kind != "admit" or not run.trace:
        return None
    tr = spans.load(run)
    spent = sum(s for name, s in tr.device_s_by_span().items()
                if name.startswith("mla.")) if tr else 0.0
    if not spent:
        return None
    return 1e3 * spent / len(run.trace["what"])
