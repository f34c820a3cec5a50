"""Completion events (the serving event-stream element)."""
from .events import ShardEvent

__all__ = ["ShardEvent"]
