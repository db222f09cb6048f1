"""Pool lanes that carry a frame, in %: the valid lanes over the pool
lanes examined, every SF, from the program's frame counters
(``lora_tpu_torch.tracing``: ``frames.valid.sf<N>`` over
``frames.lanes.sf<N>``, which ``wideband._frames_from_pooled`` adds from
the fetched results). The counters are the process's, one run a process,
so they cover every block the run drained (the warm blocks, the window's
and the traced ones), not the traced blocks alone. On a correct run it
is the traffic's uplinks over the lanes the program pools: it moves only
where the program changes how many lanes it pools. Read in a traced run;
a program without the counters reads nothing."""


def lane_yield(counters) -> float:
    """Valid lanes over pool lanes, every SF, in %; ``None`` where no
    lane was examined."""
    lanes = sum(v for k, v in counters.items() if k.startswith("frames.lanes."))
    valid = sum(v for k, v in counters.items() if k.startswith("frames.valid."))
    return 100.0 * valid / lanes if lanes else None


def read(ctx):
    if not ctx.get("trace"):
        return None
    try:
        from lora_tpu_torch import tracing
    except ImportError:
        return None
    return lane_yield(tracing.counters())
