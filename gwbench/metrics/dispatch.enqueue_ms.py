"""Host time a block spends being enqueued: ``PlanGateway.process_planes``
plus the copy of its result fields to the host, mean over the window's
blocks, in ms (host clock, the untraced window)."""


def read(ctx):
    v = ctx.get("enq_ms") or []
    return sum(v) / len(v) if v else None
