"""The map store's numpy facade, copied from `bundleadjustment_tpu/mapstate/`."""
