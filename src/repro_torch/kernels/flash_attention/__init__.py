"""Flash attention: kernel wrapper and the plain version."""
