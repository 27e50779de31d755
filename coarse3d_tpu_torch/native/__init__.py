"""ctypes bindings for the native host-preprocessing library (the port's
copy of the JAX package's ``native/``).

The reference's only native-backed hot path is open3d's C++ VoxelGrid plus
torch DataLoader worker processes (SURVEY §2); here the host pipeline's hot
loops (range-projection scatter, label scatter, voxel-grid assignment) live
in preprocess.cpp, compiled on first use with g++ -O3 into the package's
git-ignored ``build/`` directory (keyed on a source hash), beside the CUDA
kernels. Everything degrades gracefully to the NumPy
implementations if no compiler is present: `available()` gates the fast
path, and COARSE3D_NATIVE=0 disables it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "preprocess.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _build_and_load() -> ctypes.CDLL | None:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(_BUILD_DIR, f"_preprocess_{digest}.so")
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", _SRC, "-o", tmp]
        try:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, lib_path)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
    lib = ctypes.CDLL(lib_path)

    lib.c3d_range_project.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_int32,          # points, n, stride
        ctypes.c_int32, ctypes.c_int32,                 # h, w
        ctypes.c_float, ctypes.c_float,                 # fov up/down
        ctypes.c_float, ctypes.c_float,                 # fov left/right
        ctypes.c_float,                                 # max_depth
        ctypes.c_void_p,                                # depth_override
        _f32p, _f32p, _i32p, _i32p, _i32p, _f32p,       # outputs
    ]
    lib.c3d_range_project.restype = None
    lib.c3d_scatter_labels.argtypes = [_i32p, ctypes.c_int64, _i32p, _i32p]
    lib.c3d_scatter_labels.restype = None
    lib.c3d_voxelize.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_float, _i32p, _i32p]
    lib.c3d_voxelize.restype = ctypes.c_int64
    return lib


def get_lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            if os.environ.get("COARSE3D_NATIVE", "1") != "0":
                _LIB = _build_and_load()
            _TRIED = True
    return _LIB


def available() -> bool:
    return get_lib() is not None


def range_project_native(points: np.ndarray, sensor,
                         depth_override: np.ndarray | None = None,
                         mask_excludes_point0: bool = True) -> dict:
    """Drop-in replacement for ops.projection.range_project_np."""
    lib = get_lib()
    assert lib is not None
    points = np.ascontiguousarray(points, np.float32)
    n, stride = points.shape
    h, w = sensor.proj_h, sensor.proj_w
    proj_feat = np.empty((h, w, stride), np.float32)
    proj_range = np.empty((h, w), np.float32)
    proj_idx = np.empty((h, w), np.int32)
    px = np.empty(n, np.int32)
    py = np.empty(n, np.int32)
    depth = np.empty(n, np.float32)
    override_p = None
    if depth_override is not None:
        depth_override = np.ascontiguousarray(depth_override, np.float32)
        override_p = depth_override.ctypes.data_as(ctypes.c_void_p)
    lib.c3d_range_project(
        points, n, stride, h, w,
        sensor.fov_up, sensor.fov_down, sensor.fov_left, sensor.fov_right,
        sensor.max_depth, override_p,
        proj_feat.reshape(-1), proj_range.reshape(-1), proj_idx.reshape(-1),
        px, py, depth)
    if mask_excludes_point0:
        proj_mask = (proj_idx > 0).astype(np.int32)
    else:
        proj_mask = (proj_idx >= 0).astype(np.int32)
    return {
        "proj_points": proj_feat,
        "proj_range": proj_range,
        "proj_idx": proj_idx,
        "proj_mask": proj_mask,
        "px": px,
        "py": py,
        "depth": depth,
    }


def scatter_labels_native(proj_idx: np.ndarray,
                          labels: np.ndarray) -> np.ndarray:
    lib = get_lib()
    assert lib is not None
    proj_idx = np.ascontiguousarray(proj_idx, np.int32)
    labels = np.ascontiguousarray(labels, np.int32)
    out = np.empty(proj_idx.size, np.int32)
    lib.c3d_scatter_labels(proj_idx.reshape(-1), proj_idx.size, labels, out)
    return out.reshape(proj_idx.shape)


def voxelize_native(xyz: np.ndarray, voxel_size: float):
    """Returns (point2voxel (N,), first_point (V,)) like tools voxelize."""
    lib = get_lib()
    assert lib is not None
    xyz = np.ascontiguousarray(xyz[:, :3], np.float32)
    n = len(xyz)
    point2voxel = np.empty(n, np.int32)
    first_point = np.empty(n, np.int32)
    n_vox = lib.c3d_voxelize(xyz, n, 3, voxel_size, point2voxel, first_point)
    return point2voxel, first_point[:n_vox].copy()
