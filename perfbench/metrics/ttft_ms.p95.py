"""ttft_ms.p95: the 95th percentile, over every request of the window, of the
time from its batch's dispatch until its first token and its length
predictions are on the host (host clock; a batch's requests share it)."""

import numpy as np


def read(run):
    if run.kind != "admit":
        return None
    ttft = np.repeat([1e3 * (u["t_done"] - u["t_dispatch"]) for u in run.units],
                     [u["B"] for u in run.units])
    return float(np.percentile(ttft, 95))
