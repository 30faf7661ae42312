"""Native (C++) host-side data pipeline, bound via ctypes.

Replaces the per-frame OpenCV imread/remap + CSV parsing the reference does
inline on its tracking thread (src/VIOSlam.cpp:23-73, 282-306) with a
compiled library: grayscale PNG decode (libpng), bilinear rectification,
EuRoC IMU CSV parse, and a multi-threaded readahead prefetcher. The library
is compiled from io_native.cc at first use with g++ (cached next to the
source, never committed); if no toolchain or libpng is available everything
degrades to the pure-Python paths in vslam_tpu.utils.datasets.

Usage:
    from vslam_tpu import native
    if native.available():
        img = native.read_png_gray(path)
        pf = native.Prefetcher(lefts, rights, h, w, maps=None, threads=3)
        idx, left, right = pf.next()
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "io_native.cc")
_SO = os.path.join(_HERE, "_io_native.so")

_lib = None
_lib_err: str | None = None
_build_lock = threading.Lock()


def _build() -> str | None:
    """Compile the shared library if missing/stale. Returns an error string
    or None on success. Compiles to a name of this process's own and moves
    it into place atomically, so processes importing the package at once
    never load a half-written library."""
    try:
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
            return None
        tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [
            "g++", "-std=c++17", "-O3", "-shared", "-fPIC",
            _SRC, "-o", tmp, "-lpng", "-lpthread",
        ]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            return f"native build failed: {r.stderr[-500:]}"
        os.replace(tmp, _SO)
        return None
    except Exception as e:  # no compiler, no libpng, ...
        return f"native build unavailable: {e}"


def _load():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return
    with _build_lock:
        if _lib is not None or _lib_err is not None:
            return
        err = _build()
        if err is not None:
            _lib_err = err
            return
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:
            _lib_err = f"native load failed: {e}"
            return
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.vt_png_probe.argtypes = [ctypes.c_char_p, i32p, i32p]
        lib.vt_png_probe.restype = ctypes.c_int
        lib.vt_png_read_gray.argtypes = [
            ctypes.c_char_p, u8p, i32p, i32p, ctypes.c_int, ctypes.c_int,
        ]
        lib.vt_png_read_gray.restype = ctypes.c_int
        lib.vt_remap_bilinear_u8.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, f32p, f32p, u8p,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.vt_remap_bilinear_u8.restype = None
        lib.vt_parse_imu_csv.argtypes = [ctypes.c_char_p, f64p, ctypes.c_long]
        lib.vt_parse_imu_csv.restype = ctypes.c_long
        lib.vt_prefetch_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
        ]
        lib.vt_prefetch_create.restype = ctypes.c_void_p
        lib.vt_prefetch_next.argtypes = [ctypes.c_void_p, u8p, u8p]
        lib.vt_prefetch_next.restype = ctypes.c_long
        lib.vt_prefetch_destroy.argtypes = [ctypes.c_void_p]
        lib.vt_prefetch_destroy.restype = None
        _lib = lib


def available() -> bool:
    _load()
    return _lib is not None


def build_error() -> str | None:
    _load()
    return _lib_err


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray | None):
    if a is None:
        return ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def probe_png(path: str) -> tuple[int, int]:
    """(height, width) of a PNG without decoding it."""
    _load()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = _lib.vt_png_probe(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"vt_png_probe({path}) failed rc={rc}")
    return h.value, w.value


def read_png_gray(path: str, max_h: int = 4096, max_w: int = 8192) -> np.ndarray:
    """Decode a PNG to (H, W) uint8 grayscale (any color type converted)."""
    _load()
    ph, pw = probe_png(path)
    out = np.empty((min(ph, max_h), min(pw, max_w)), np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = _lib.vt_png_read_gray(
        path.encode(), _u8(out), ctypes.byref(h), ctypes.byref(w), ph, pw
    )
    if rc != 0:
        raise IOError(f"vt_png_read_gray({path}) failed rc={rc}")
    return out[: h.value, : w.value]


def remap_bilinear_u8(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """cv::remap-style bilinear resampling of a uint8 image with float32
    coordinate maps (BORDER_CONSTANT=0)."""
    _load()
    src = np.ascontiguousarray(src, np.uint8)
    map_x = np.ascontiguousarray(map_x, np.float32)
    map_y = np.ascontiguousarray(map_y, np.float32)
    oh, ow = map_x.shape
    dst = np.empty((oh, ow), np.uint8)
    _lib.vt_remap_bilinear_u8(
        _u8(src), src.shape[0], src.shape[1], _f32(map_x), _f32(map_y),
        _u8(dst), oh, ow,
    )
    return dst


def parse_imu_csv(path: str, max_rows: int = 1 << 22) -> np.ndarray:
    """EuRoC imu0/data.csv -> (N, 7) float64 [t_sec, gyro, accel] rows."""
    _load()
    out = np.empty((max_rows, 7), np.float64)
    n = _lib.vt_parse_imu_csv(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_rows
    )
    if n < 0:
        raise IOError(f"vt_parse_imu_csv({path}) failed")
    return out[:n].copy()


class Prefetcher:
    """Multi-threaded decode(+rectify) readahead over an image sequence.

    Frames are decoded out of order by worker threads and delivered strictly
    in order by :meth:`next`. `maps` is an optional
    (map_lx, map_ly, map_rx, map_ry) float32 tuple applied as rectification
    after decode (the reference's initUndistortRectifyMap + remap,
    src/VIOSlam.cpp:282-306)."""

    def __init__(
        self,
        left_paths: list[str],
        right_paths: list[str] | None,
        height: int,
        width: int,
        maps=None,
        threads: int = 3,
        queue_cap: int = 6,
    ):
        _load()
        if _lib is None:
            raise RuntimeError(_lib_err or "native library unavailable")
        self.h, self.w = height, width
        self.stereo = bool(right_paths)
        self._maps = None
        mxl = myl = mxr = myr = None
        if maps is not None:
            mxl, myl, mxr, myr = (
                np.ascontiguousarray(m, np.float32) if m is not None else None
                for m in maps
            )
            self._maps = (mxl, myl, mxr, myr)  # keep alive for C
        self._hd = _lib.vt_prefetch_create(
            "\n".join(left_paths).encode(),
            "\n".join(right_paths).encode() if right_paths else b"",
            height,
            width,
            _f32(mxl),
            _f32(myl),
            _f32(mxr),
            _f32(myr),
            threads,
            queue_cap,
        )
        self.n = len(left_paths)

    def next(self):
        """(index, left, right|None); index == -1 past the end."""
        left = np.empty((self.h, self.w), np.uint8)
        right = np.empty((self.h, self.w), np.uint8) if self.stereo else None
        idx = _lib.vt_prefetch_next(
            self._hd, _u8(left), _u8(right) if right is not None else _u8(left)
        )
        if idx < 0:
            return -1, None, None
        return idx, left, right

    def close(self):
        if self._hd:
            _lib.vt_prefetch_destroy(self._hd)
            self._hd = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        while True:
            idx, left, right = self.next()
            if idx < 0:
                return
            yield idx, left, right
