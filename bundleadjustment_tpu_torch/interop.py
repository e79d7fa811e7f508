"""Carry state from the JAX reference package into the port.

`from_reference(obj, device)` turns one of the JAX package's NamedTuples
(problems, features, configs), with array fields as JAX or numpy arrays,
into the port's dataclass on `device`, so both packages can compute on
identical inputs. It dispatches on the class name and never imports jax:
array fields are read through `numpy.asarray`.

Conversions: index arrays of the flat problem become int64, the dense
layout keeps int32 camera indices, and packed uint32 descriptor words keep
their bit patterns as int32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bundleadjustment_tpu_torch.device import resolve_device
from bundleadjustment_tpu_torch.ops.features import FeatureConfig, Features
from bundleadjustment_tpu_torch.solvers.dense_ba import _CM, DenseBAProblem
from bundleadjustment_tpu_torch.solvers.lm import LMConfig, MotionOnlyConfig
from bundleadjustment_tpu_torch.solvers.residuals import BAProblem

_INT64_FIELDS = {"BAProblem": ("cam_idx", "pt_idx")}
_TENSORS = {"DenseBAProblem": DenseBAProblem, "_CM": _CM,
            "BAProblem": BAProblem, "Features": Features}
_CONFIGS = {"FeatureConfig": FeatureConfig, "LMConfig": LMConfig,
            "MotionOnlyConfig": MotionOnlyConfig}


def to_tensor(a, device, int64=False):
    """numpy / JAX array -> tensor on `device` (uint32 -> int32 bits)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a))
    if int64:
        t = t.to(torch.int64)
    return t.to(device)


def from_reference(obj, device="cuda"):
    """Convert a JAX-package NamedTuple to the port's counterpart; tensors
    go to `device` (the card unless the caller asks for the CPU; configs
    carry no tensors and ignore it)."""
    name = type(obj).__name__
    fields = obj._asdict()
    if name in _CONFIGS:
        cls = _CONFIGS[name]
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in fields.items() if k in names})
    if name in _TENSORS:
        cls = _TENSORS[name]
        device = resolve_device(device)
        wide = _INT64_FIELDS.get(name, ())
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: to_tensor(v, device, k in wide)
                      for k, v in fields.items() if k in names})
    raise TypeError(f"no port counterpart for {name}")
