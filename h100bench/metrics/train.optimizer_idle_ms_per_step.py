"""Device idle ms a step in the gaps that open while the innermost
program span open on the host is ``train.clip``, ``train.optimizer`` or
``train.apply``."""
from h100bench import program_spans


def read(ctx):
    return program_spans.idle_ms_per_unit(ctx.trace, "train.step",
                                          program_spans.OPTIMIZER)
