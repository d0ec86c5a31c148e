"""setup_s: process start to the start of the measured window (import, the
kernels' libraries, the weights drawn on the card, the warm-up), host clock."""


def read(run):
    return run.setup_s
