"""Trajectory and reconstruction metrics (port of `bundleadjustment_tpu.metrics`)."""

from bundleadjustment_tpu_torch.metrics.ate import align_horn_scale, ate_rmse, evaluate_ate
from bundleadjustment_tpu_torch.metrics.reconstruction import (
    icp_align,
    reconstruction_error,
)

__all__ = [
    "align_horn_scale",
    "ate_rmse",
    "evaluate_ate",
    "icp_align",
    "reconstruction_error",
]
