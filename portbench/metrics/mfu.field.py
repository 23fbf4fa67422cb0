"""mfu.field: the whole field step's share of the card's float32 peak, in
percent: 2 x forward_macs x sources deblended in the measured window's
fields, over the window's seconds, over the peak (the forward is the only
work counted; detection, the render and the transfers add time)."""

from portbench.work import PEAK_FLOPS, forward_macs


def read(ctx):
    model = ctx.config["model"]
    if not ctx.stats["window_s"] > 0 or not ctx.stats.get("sources"):
        return None
    flops = 2.0 * forward_macs(model) * ctx.stats["sources"]
    return 100.0 * flops / ctx.stats["window_s"] / PEAK_FLOPS[model["dtype"]]
