"""The plain reference of the benchmark's check: float64 PyTorch, no program code."""
