"""The SLAM pipeline on tensors (port of `bundleadjustment_tpu.pipeline`)."""
