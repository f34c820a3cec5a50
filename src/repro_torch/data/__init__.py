"""The port's data pipeline: step-keyed synthetic token batches."""
from .pipeline import SyntheticTokens

__all__ = ["SyntheticTokens"]
