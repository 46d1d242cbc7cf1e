"""Correctness gate and device timing."""
