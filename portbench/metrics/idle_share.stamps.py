"""idle_share.stamps: the share of the traced sub-window, in percent, in which no
kernel, copy or memset ran on the device."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["busy_s"] > 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
