"""Small utilities (port of `bundleadjustment_tpu.utils`)."""
