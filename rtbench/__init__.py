"""The port's benchmark: see rtbench/run.py and PERF.md."""
