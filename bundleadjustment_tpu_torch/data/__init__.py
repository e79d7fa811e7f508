"""Dataset loaders and synthetic scenes (numpy only), copied from
`bundleadjustment_tpu/data/` so that the port runs without the JAX package."""
