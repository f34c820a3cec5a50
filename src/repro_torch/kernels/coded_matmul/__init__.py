"""Coded worker-task matmul: kernel wrappers and the plain version."""
