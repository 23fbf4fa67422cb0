"""idle_unattributed.field: the share of the device's idle time in the traced
sub-window, in percent, that no host op or program span explains: the
idle seconds the trace labels 'no host op' (no op or annotation running
at the gap's midpoint), over the window's seconds less its busy ones.
The breakdown keeps the ten labels with the most idle time; where 'no
host op' is not among ten, the tenth's share is given, a bound from
above."""

LABEL = "no host op"


def read(ctx):
    if ctx.trace is None:
        return None
    idle = ctx.trace["window_s"] - ctx.trace["busy_s"]
    if not idle > 0:
        return None
    gaps = dict(ctx.trace["idle_gaps"])
    if LABEL in gaps:
        seconds = gaps[LABEL]
    else:
        seconds = ctx.trace["idle_gaps"][-1][1] if len(ctx.trace["idle_gaps"]) >= 10 else 0.0
    return 100.0 * seconds / idle
