"""Device time of Phase B and the decode tail a block: the kernels
launched inside every SF's ``DenseReceiver.process_pooled_planes`` span,
summed over the SFs, over the traced blocks, in ms."""


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    spans = {k: v for k, v in t["span_device_s"].items() if k.startswith("gw.phaseb.sf")}
    if not spans:
        return None
    return 1e3 * sum(spans.values()) / t["blocks"]
