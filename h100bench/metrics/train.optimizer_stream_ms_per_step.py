"""Stream ms a step after the backward: the ``train.clip``,
``train.optimizer`` (the per-tensor AdamW) and ``train.apply`` spans,
from their timing events.  A stream interval, not busy time: it holds the
idle of the launch-bound host loop, which
``train.optimizer_idle_ms_per_step`` also counts."""
from h100bench import program_spans


def read(ctx):
    return program_spans.stream_ms_per_unit(ctx.trace, "train.step",
                                            program_spans.OPTIMIZER)
