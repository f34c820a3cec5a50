"""Kernel launches a step (``cudaLaunchKernel*``, ``cuLaunchKernel*``
runtime calls) that start inside the ``train.clip``, ``train.optimizer``
and ``train.apply`` spans of the profiled window's trace."""
from h100bench import program_spans


def read(ctx):
    return program_spans.launches_per_unit(ctx.trace, "train.step",
                                           program_spans.OPTIMIZER)
