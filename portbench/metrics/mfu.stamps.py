"""mfu.stamps: the stamp forward's share of the card's published peak for
the configuration's dtype, in percent: 2 x forward_macs x stamps completed
in the measured window, over the window's seconds, over the peak."""

from portbench.work import PEAK_FLOPS, forward_macs


def read(ctx):
    model = ctx.config["model"]
    if not ctx.stats["window_s"] > 0:
        return None
    flops = 2.0 * forward_macs(model) * ctx.stats["units"]
    return 100.0 * flops / ctx.stats["window_s"] / PEAK_FLOPS[model["dtype"]]
