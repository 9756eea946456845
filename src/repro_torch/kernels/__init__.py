"""Kernel wrappers, their plain twins, and the CUDA build."""
