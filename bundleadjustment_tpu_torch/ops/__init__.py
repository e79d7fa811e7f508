"""Feature frontend and descriptor matching (port of `bundleadjustment_tpu.ops`)."""
