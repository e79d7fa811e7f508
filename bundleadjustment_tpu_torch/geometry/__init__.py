"""Rigid-body geometry on tensors (port of `bundleadjustment_tpu.geometry`)."""
