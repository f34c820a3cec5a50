"""The optimizer of the port's training stack."""
from .adamw import (AdamWState, adamw_init, adamw_update, clip_by_global_norm,
                    cosine_schedule, wsd_schedule)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "wsd_schedule", "clip_by_global_norm"]
