"""Bundle-adjustment solvers on tensors (port of `bundleadjustment_tpu.solvers`)."""
