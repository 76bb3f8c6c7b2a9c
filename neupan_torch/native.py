"""ctypes bindings for the native host library (native/neupan_host.cpp).

The port's own copy of ``neupan_tpu/native.py``. The planner math runs on
the card; these native host routines cover the host-side
per-tick loops (lidar scan conversion, raycast simulation, path tracking).
Every binding has a pure-numpy fallback, so the library is optional:
``available()`` reports whether the .so was found/loaded.

Build: ``sh native/build.sh`` (g++ -O3 -shared).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_INT32_P = ctypes.POINTER(ctypes.c_int32)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "native", "libneupan_host.so")
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None

    lib.scan_to_points.restype = ctypes.c_int
    lib.scan_to_points.argtypes = [
        _DOUBLE_P, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _DOUBLE_P, _DOUBLE_P, _DOUBLE_P, _DOUBLE_P, _DOUBLE_P,
    ]
    lib.raycast.restype = None
    lib.raycast.argtypes = [
        _DOUBLE_P, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_double, ctypes.c_double,
        _DOUBLE_P, ctypes.c_int, _DOUBLE_P, _INT32_P,
    ]
    lib.closest_point_index.restype = ctypes.c_int
    lib.closest_point_index.argtypes = [
        _DOUBLE_P, _DOUBLE_P, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _dp(arr: np.ndarray) -> _DOUBLE_P:
    return arr.ctypes.data_as(_DOUBLE_P)


def scan_to_points(ranges, angle_min, angle_max, range_min, range_max,
                   angle_range, down_sample, offset, state, velocity=None,
                   offset_inverse=False, min_inclusive=False
                   ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Native scan -> world-frame point conversion.  Returns (points, vels)
    or (None, None) when no beam survives filtering."""
    lib = _load()
    assert lib is not None
    ranges = np.ascontiguousarray(ranges, dtype=np.float64)
    n = len(ranges)
    out_p = np.empty((n, 2), dtype=np.float64)
    out_v = np.empty((n, 2), dtype=np.float64)
    vel = None
    if velocity is not None:
        vel = np.ascontiguousarray(velocity, dtype=np.float64)
    off = np.ascontiguousarray(np.reshape(offset, 3), dtype=np.float64)
    st = np.ascontiguousarray(np.reshape(state, -1)[:3], dtype=np.float64)
    kept = lib.scan_to_points(
        _dp(ranges), n, float(angle_min), float(angle_max), float(range_min),
        float(range_max), float(angle_range[0]), float(angle_range[1]),
        int(down_sample), int(offset_inverse), int(min_inclusive),
        _dp(vel) if vel is not None else None, _dp(off), _dp(st),
        _dp(out_p), _dp(out_v))
    if kept == 0:
        return None, None
    return out_p[:kept].T.copy(), out_v[:kept].T.copy()


def raycast(origin, heading, angle_min, angle_max, n_beams, range_min,
            range_max, segments) -> Tuple[np.ndarray, np.ndarray]:
    """Native lidar raycast.  segments: (S, 2, 2) -> (ranges, hit_index)."""
    lib = _load()
    assert lib is not None
    segs = np.ascontiguousarray(segments, dtype=np.float64).reshape(-1, 4)
    org = np.ascontiguousarray(np.reshape(origin, 2), dtype=np.float64)
    out_r = np.empty(n_beams, dtype=np.float64)
    out_s = np.empty(n_beams, dtype=np.int32)
    lib.raycast(_dp(org), float(heading), float(angle_min), float(angle_max),
                int(n_beams), float(range_min), float(range_max), _dp(segs),
                segs.shape[0], _dp(out_r),
                out_s.ctypes.data_as(_INT32_P))
    return out_r, out_s


def closest_point_index(path_xy: np.ndarray, state_xy, start: int,
                        ind_range: int, threshold: float) -> int:
    """Native sliding-window closest point.  path_xy: (2, N)."""
    lib = _load()
    assert lib is not None
    px = np.ascontiguousarray(path_xy[0], dtype=np.float64)
    py = np.ascontiguousarray(path_xy[1], dtype=np.float64)
    return int(lib.closest_point_index(
        _dp(px), _dp(py), px.shape[0], float(state_xy[0]), float(state_xy[1]),
        int(start), int(ind_range), float(threshold)))
