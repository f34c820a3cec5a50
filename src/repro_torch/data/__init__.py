"""The port's data pipeline: step-keyed synthetic token batches."""
from .pipeline import SyntheticTokens, make_batch_specs

__all__ = ["SyntheticTokens", "make_batch_specs"]
