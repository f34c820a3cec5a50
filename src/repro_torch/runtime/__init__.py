"""Step builders of the port (prefill and decode)."""
