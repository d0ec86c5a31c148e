"""launches_per_step.collect: kernel launches in the traced decode steps (each
with its sampling and the engine's per-step sync), per step."""


def read(run):
    if run.kind != "collect" or not run.trace:
        return None
    return run.trace["launches"] / run.trace["what"]["steps"]
