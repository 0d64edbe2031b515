"""Benchmark acceptance thresholds (the port's copy of
mapfree_tpu/benchmark/config.py; reference: benchmark/config.py:1-8)."""

# Pose error thresholds: translation [m] and rotation [deg]
t_threshold = 0.25
R_threshold = 5

# Virtual Correspondence Reprojection Error threshold [px]
vcre_threshold = 90
