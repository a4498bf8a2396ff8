"""Benchmark of vri_tpu_torch: see perfbench/run.py."""
