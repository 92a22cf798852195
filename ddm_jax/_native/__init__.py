"""Native (C++) host-topology kernels, loaded via ctypes.

``load()`` returns the shared library handle or None (pure-Python fallback
in core/indexmaps.py is always available).  The library is compiled lazily
with g++ and cached next to the source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "ddmcore.cpp")
_LIB = os.path.join(_HERE, "libddmcore.so")

_lib = None
_tried = False


def build(force: bool = False) -> str | None:
    """Compile the shared library (cached by mtime)."""
    if (
        not force
        and os.path.exists(_LIB)
        and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
    ):
        return _LIB
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        _SRC, "-o", _LIB,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        return _LIB
    except Exception:
        return None


def load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("DDM_NO_NATIVE"):
        return None
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.ddm_topology_compute.restype = ctypes.c_int64
    lib.ddm_topology_compute.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.ddm_topology_collect.restype = None
    lib.ddm_topology_collect.argtypes = [ctypes.c_void_p] * 4
    _lib = lib
    return _lib
