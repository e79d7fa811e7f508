"""Distributed solvers on torch.distributed (port of `bundleadjustment_tpu.parallel`)."""
