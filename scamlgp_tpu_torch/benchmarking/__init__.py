"""Benchmarks (Branin) and their torch adapters for lock-step campaigns."""
