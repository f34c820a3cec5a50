"""Polynomial encode: kernel wrapper and the plain version."""
