"""launches_per_batch.stamps: kernels the device ran in the traced sub-window, per
batch of stamps traced."""


def read(ctx):
    if ctx.trace is None or ctx.trace["kernels"] == 0:
        return None
    return ctx.trace["kernels"] / ctx.trace["steps"]
