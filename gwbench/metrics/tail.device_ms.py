"""Device time of the decode tail a block: the kernels launched inside
the program's ``lora.tail`` spans (``DenseReceiver._finish_decode``:
header parse, deinterleave, Hamming decode, dewhitening, CRC), summed
over the SFs, over the traced blocks, in ms. A program without the span
reads nothing."""


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    dev = t["span_device_s"].get("lora.tail")
    if dev is None:
        return None
    return 1e3 * dev / t["blocks"]
