"""Host time from a block's event (its results on the host) to its
frames built (``wideband._frames_from_pooled`` for every SF), mean over
the window's blocks, in ms (host clock, the untraced window)."""


def read(ctx):
    v = ctx.get("frames_ms") or []
    return sum(v) / len(v) if v else None
