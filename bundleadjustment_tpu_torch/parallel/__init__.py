"""Distributed solvers on torch.distributed (port of `bundleadjustment_tpu.parallel`).

Exports what the reference's `parallel/__init__.py` does, as far as it is
ported: the flat landmark-sharded engine. The reference's
`detect_batch_sharded` (`parallel/frontend.py`) is not ported yet (ROADMAP
queue 1, item 10).
"""

from bundleadjustment_tpu_torch.parallel.sharded_ba import (
    ShardedBAProblem,
    shard_problem,
    sharded_ba_solve,
)

__all__ = [
    "ShardedBAProblem",
    "shard_problem",
    "sharded_ba_solve",
]
