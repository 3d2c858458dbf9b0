"""Build + ctypes binding for the native DER scoring core.

Compiles score/native/der_core.cpp with g++ on first use (cached .so keyed
by source mtime). Falls back silently to the pure-Python scorer when no
compiler is available — both paths share identical semantics and are
cross-checked in tests/test_native_der.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "der_core.cpp")
_SO = os.path.join(_HERE, "native", "der_core.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def build(force: bool = False) -> Optional[str]:
    if os.path.exists(_SO) and not force and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _SO],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return _SO
    except Exception:
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if os.environ.get("SDT_NATIVE_DER", "1") == "0":
        return None
    so = build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    D = ctypes.POINTER(ctypes.c_double)
    I = ctypes.POINTER(ctypes.c_int32)
    lib.sdt_score_der_file.restype = ctypes.c_int
    lib.sdt_score_der_file.argtypes = [
        D, D, I, ctypes.c_int, ctypes.c_int,
        D, D, I, ctypes.c_int, ctypes.c_int,
        D, D, ctypes.c_int,
        ctypes.c_double, ctypes.c_int,
        D, I,
    ]
    lib.sdt_validate_rttm.restype = ctypes.c_int
    lib.sdt_validate_rttm.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    _lib = lib
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def validate_rttm_file(path: str) -> tuple[int, int]:
    """(n_bad_lines, first_bad_line_no). Requires the native lib."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native DER core unavailable")
    with open(path, "rb") as f:
        buf = f.read()
    first = ctypes.c_int64(0)
    bad = lib.sdt_validate_rttm(buf, len(buf), ctypes.byref(first))
    return bad, int(first.value)
