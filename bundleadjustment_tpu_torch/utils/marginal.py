"""Marginal per-iteration timing by a least-squares fit over iteration counts.

Port of `bundleadjustment_tpu/utils/marginal.py`. Wall time is measured at
>= 4 iteration counts (best of >= 2 repeats each: host-side noise is a
one-sided delay, so the best is the unbiased choice), and the marginal time
an iteration is the slope of an ordinary least-squares line t(n) = slope *
n + intercept. The intercept takes the fixed cost of a call (set-up, the
seed evaluation, the final synchronize); the slope is the time an
iteration adds. The slope's standard error (from the residuals, n - 2
degrees of freedom) is reported beside it, so a noisy run shows.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Sequence


def fit_line(xs: Sequence[float], ys: Sequence[float]):
    """OLS fit y = slope*x + intercept.  Returns (slope, intercept,
    slope_stderr).  stderr is NaN with fewer than 3 points."""
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    slope = sxy / sxx
    intercept = my - slope * mx
    if n > 2:
        ss_res = sum((y - (slope * x + intercept)) ** 2
                     for x, y in zip(xs, ys))
        stderr = math.sqrt(ss_res / (n - 2) / sxx)
    else:
        stderr = float("nan")
    return slope, intercept, stderr


def measure_marginal(
    time_fn: Callable[[int], float],
    iter_counts: Sequence[int] = (5, 10, 20, 40),
    repeats: int = 3,
):
    """Measure marginal seconds/iteration of a scan-length-parameterized
    computation.

    `time_fn(n_iters)` must run the computation once (post-warmup) and
    return wall seconds.  Each count is timed `repeats` times and the best
    kept.  Returns a dict with slope/intercept/stderr (seconds),
    iters_per_s, and the raw (count, best_seconds) points for the record.
    """
    pts = []
    for it in iter_counts:
        best = min(time_fn(it) for _ in range(repeats))
        pts.append((it, best))
    slope, intercept, stderr = fit_line([p[0] for p in pts],
                                        [p[1] for p in pts])
    slope = max(slope, 1e-12)
    return {
        "slope_s": slope,
        "intercept_s": intercept,
        "slope_stderr_s": stderr,
        "iters_per_s": 1.0 / slope,
        "iters_per_s_lo": 1.0 / (slope + stderr) if stderr == stderr else None,
        "iters_per_s_hi": (1.0 / max(slope - stderr, 1e-12)
                           if stderr == stderr else None),
        "points": pts,
    }


def sustained_ms(fn: Callable[[], object], sync: Callable[[], object], n: int = 50,
                 reps: int = 3) -> float:
    """Sustained milliseconds a call: `n` back-to-back calls of `fn`, ended by
    one `sync()` (`torch.cuda.synchronize` on the card, so the time covers
    the device work), best of `reps` after one warm-up call."""
    fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e3
