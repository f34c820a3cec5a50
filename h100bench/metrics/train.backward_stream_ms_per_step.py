"""Stream ms a step of the backward, the remat's recompute inside it: the
``train.backward`` span around ``torch.autograd.grad``, from its timing
events (the backward's kernels run on the step's stream).  A stream
interval, not busy time."""
from h100bench import program_spans


def read(ctx):
    return program_spans.stream_ms_per_unit(ctx.trace, "train.step",
                                            ("train.backward",))
