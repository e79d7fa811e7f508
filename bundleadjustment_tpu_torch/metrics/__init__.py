"""Trajectory metrics (port of `bundleadjustment_tpu.metrics`; ATE only)."""
