"""The shared detection pass's share of its roofline, in %: the least
time of one ``multi_sf_detection_metrics`` call over the channel planes
(``yardstick.lag_bound_s``: float32 planes ``[C, 2, n_out]`` read once
and the energy and lag-product rows written once, at the memory peak, or
their flops at the float32 peak) over the device time of the kernels
launched inside its span, a call."""

from gwbench.yardstick import lag_bound_s


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    dev, calls = t["span_device_s"].get("gw.detect"), t["span_calls"].get("gw.detect")
    if not dev or not calls:
        return None
    g, cfg = ctx["geo"], ctx["cfg"]
    os_ = int(round(cfg["chan_rate"] / cfg["bandwidth"]))
    sps = {sf: (1 << sf) * os_ for sf in cfg["sfs"]}
    lags = sorted({s // min(sps.values()) for s in sps.values()})
    bound = lag_bound_s(g["C"], g["n_out"], 4, min(sps.values()), lags)
    return 100.0 * bound / (dev / calls)
