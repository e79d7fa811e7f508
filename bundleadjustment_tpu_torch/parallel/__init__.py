"""Distributed solvers on torch.distributed (port of `bundleadjustment_tpu.parallel`).

Exports what the reference's `parallel/__init__.py` does: the flat
landmark-sharded engine and the data-parallel frontend.
"""

from bundleadjustment_tpu_torch.parallel.frontend import detect_batch_sharded
from bundleadjustment_tpu_torch.parallel.sharded_ba import (
    ShardedBAProblem,
    shard_problem,
    sharded_ba_solve,
)

__all__ = [
    "ShardedBAProblem",
    "detect_batch_sharded",
    "shard_problem",
    "sharded_ba_solve",
]
