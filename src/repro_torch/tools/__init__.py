"""Command-line tools of the port, run as ``python -m
repro_torch.tools.<name>``: ``sac_top`` (the serve dashboard and the
offline tail attribution)."""
