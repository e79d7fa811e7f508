"""Map / mesh outputs (port of `bundleadjustment_tpu.vis`; mesh writers only)."""
