"""The channelizer's share of its roofline, in %: the least time of one
``PlanGateway.channel_planes`` call (``yardstick.channelizer_bound_s``:
the least float32 operations at the float32 peak, or the planes read
once and the channel planes written once at the memory peak, whichever
is longer) over the device time of the kernels launched inside its span,
a call. The card's name and power limit go beside it in ``info.card``."""

from gwbench.yardstick import channelizer_bound_s


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    dev, calls = t["span_device_s"].get("gw.channel_planes"), t["span_calls"].get(
        "gw.channel_planes")
    if not dev or not calls:
        return None
    g = ctx["geo"]
    return 100.0 * channelizer_bound_s(g["C"], g["D"], g["K"], g["L"], g["n_out"]) / (dev / calls)
