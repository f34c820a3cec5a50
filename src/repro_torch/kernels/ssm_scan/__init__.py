"""Selective scan: kernel wrapper and the plain version."""
