"""ctypes loader for the native map-store runtime (builds on demand).

Copied from `bundleadjustment_tpu/native/__init__.py` with `mapstore.cpp`,
so that the port runs where the JAX package is absent. The one change: g++
builds the library into `bundleadjustment_tpu_torch/_build/` (listed in
.gitignore), beside the CUDA kernels, with the flags of the JAX package's
Makefile.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(_BUILD, "libmapstore.so")
_SRC = os.path.join(_DIR, "mapstore.cpp")
_lock = threading.Lock()
_lib = None


def _build():
    os.makedirs(_BUILD, exist_ok=True)
    tmp = _SO + f".{os.getpid()}.tmp"
    proc = subprocess.run(
        [os.environ.get("CXX", "g++"), "-O2", "-std=c++17", "-fPIC", "-Wall",
         "-Wextra", "-shared", "-o", tmp, _SRC],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, _SO)


def load():
    """Load (building if stale/missing) the libmapstore shared object."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_SO)
        _declare(lib)
        _lib = lib
        return lib


c_i32 = ctypes.c_int32
c_f32 = ctypes.c_float
c_f64 = ctypes.c_double
c_u32 = ctypes.c_uint32
c_u8 = ctypes.c_uint8
P = ctypes.POINTER


def _declare(lib):
    sigs = {
        "map_create": ([c_i32] * 4, ctypes.c_void_p),
        "map_destroy": ([ctypes.c_void_p], None),
        "map_add_frame": (
            [ctypes.c_void_p, c_f64, P(c_f64), P(c_f64), c_i32, P(c_f32), P(c_i32), P(c_f32), P(c_u32)],
            c_i32,
        ),
        "map_set_keyframe": ([ctypes.c_void_p, c_i32, c_i32], None),
        "map_set_pose": ([ctypes.c_void_p, c_i32, P(c_f64)], None),
        "map_get_pose": ([ctypes.c_void_p, c_i32, P(c_f64)], None),
        "map_erase_frame": ([ctypes.c_void_p, c_i32], None),
        "map_add_point": ([ctypes.c_void_p, P(c_f32), P(c_u32), c_i32], c_i32),
        "map_set_point_pos": ([ctypes.c_void_p, c_i32, P(c_f32)], None),
        "map_add_observation": ([ctypes.c_void_p, c_i32, c_i32, c_i32], c_i32),
        "map_remove_observation": ([ctypes.c_void_p, c_i32, c_i32], None),
        "map_erase_point": ([ctypes.c_void_p, c_i32], None),
        "map_fuse_points": ([ctypes.c_void_p, c_i32, c_i32], None),
        "map_set_outlier": ([ctypes.c_void_p, c_i32, c_i32, c_i32], None),
        "map_point_obs_count": ([ctypes.c_void_p, c_i32], c_i32),
        "map_point_obs_counts": ([ctypes.c_void_p, P(c_i32), c_i32, P(c_i32)], None),
        "map_update_covisibility": ([ctypes.c_void_p, c_i32, c_i32], None),
        "map_best_covisible": ([ctypes.c_void_p, c_i32, c_i32, P(c_i32), P(c_i32)], c_i32),
        "map_cull_recent_points": (
            [ctypes.c_void_p, c_i32, c_i32, c_i32, P(c_i32), c_i32],
            c_i32,
        ),
        "map_cull_redundant_keyframes": (
            [ctypes.c_void_p, c_f64, c_i32, c_i32, P(c_i32), c_i32],
            c_i32,
        ),
        "map_num_frames": ([ctypes.c_void_p], c_i32),
        "map_num_points": ([ctypes.c_void_p], c_i32),
        "map_count_active_keyframes": ([ctypes.c_void_p], c_i32),
        "map_active_keyframes": ([ctypes.c_void_p, P(c_i32), c_i32], c_i32),
        "map_count_active_points": ([ctypes.c_void_p], c_i32),
        "map_active_points": ([ctypes.c_void_p, P(c_i32), c_i32], c_i32),
        "map_export_observations": (
            [ctypes.c_void_p, P(c_i32), c_i32, c_i32, P(c_i32), P(c_i32), P(c_f32), P(c_f32), P(c_i32), c_i32],
            c_i32,
        ),
        "map_point_observations": (
            [ctypes.c_void_p, c_i32, P(c_i32), P(c_i32), c_i32],
            c_i32,
        ),
        "map_point_view_dirs": ([ctypes.c_void_p, P(c_i32), c_i32, P(c_f64)], None),
        "map_refresh_point_descriptors": ([ctypes.c_void_p, P(c_i32), c_i32], None),
        "map_point_has_outlier_obs": ([ctypes.c_void_p, P(c_i32), c_i32, P(c_u8)], None),
        "map_refresh_frame_points": ([ctypes.c_void_p, c_i32], c_i32),
        "map_window_closure": (
            [ctypes.c_void_p, P(c_i32), c_i32, P(c_i32), c_i32, P(c_i32), c_i32, P(c_i32)],
            c_i32,
        ),
        "map_pt_pos_ptr": ([ctypes.c_void_p], P(c_f32)),
        "map_pt_active_ptr": ([ctypes.c_void_p], P(c_u8)),
        "map_kf_pose_ptr": ([ctypes.c_void_p], P(c_f64)),
        "map_kf_gt_ptr": ([ctypes.c_void_p], P(c_f64)),
        "map_kf_active_ptr": ([ctypes.c_void_p], P(c_u8)),
        "map_kf_is_keyframe_ptr": ([ctypes.c_void_p], P(c_u8)),
        "map_kf_timestamp_ptr": ([ctypes.c_void_p], P(c_f64)),
        "map_kp_pt_ptr": ([ctypes.c_void_p], P(c_i32)),
        "map_kp_outlier_ptr": ([ctypes.c_void_p], P(c_u8)),
        "map_kp_xy_ptr": ([ctypes.c_void_p], P(c_f32)),
        "map_kp_sigma2_ptr": ([ctypes.c_void_p], P(c_f32)),
        "map_kp_octave_ptr": ([ctypes.c_void_p], P(c_i32)),
        "map_kp_desc_ptr": ([ctypes.c_void_p], P(c_u32)),
        "map_pt_desc_ptr": ([ctypes.c_void_p], P(c_u32)),
        "map_kf_nkp_ptr": ([ctypes.c_void_p], P(c_i32)),
        "map_pt_first_kf_ptr": ([ctypes.c_void_p], P(c_i32)),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
