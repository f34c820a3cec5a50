"""Offline analysis of serve runs.

* :mod:`~repro_torch.analysis.attribution` — splits each request's
  time-to-target into queue, operand-ship, compute, wait and decode from a
  trace document and the serve report's request records, using the
  cluster workers' timing triples.
"""
