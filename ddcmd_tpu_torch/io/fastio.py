"""ctypes binding for the native record codec.

The C source is the port's own copy of the JAX package's codec,
`ddcmd_tpu_torch/csrc/recio.c`: the port reads no file of the JAX
package.  It is compiled
with the host C compiler on first use into `ddcmd_tpu_torch/_build/`;
every caller falls back to the pure-Python path when the toolchain or
the source is unavailable, so the native layer is an accelerator, never
a dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

FK_SKIP, FK_FLOAT, FK_UDEC, FK_UHEX, FK_STR = 0, 1, 2, 3, 4
_STR_WIDTH = 16

_lock = threading.Lock()
_lib = None
_tried = False


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "recio.c")
_BUILD = os.path.join(_PKG, "_build")


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = os.path.join(_BUILD, "libddcmdrecio.so")
        src = _SRC
        try:
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                os.makedirs(_BUILD, exist_ok=True)
                # build beside, then rename: concurrent processes never
                # load a half-written library
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", tmp,
                                src], check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.SubprocessError):
            return None
        lib.recio_parse.restype = ctypes.c_long
        lib.recio_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_char_p]
        lib.recio_format.restype = ctypes.c_long
        lib.recio_format.argtypes = [
            ctypes.c_long, ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_long]
        _lib = lib
        return _lib


def parse_records(body: bytes, field_types: list[str], max_records: int,
                  gid_hex: bool):
    """Parse VARRECORDASCII body -> (floats dict-by-col-order, uints, strs).

    Returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    kinds = []
    for ft in field_types:
        if ft.startswith("f"):
            kinds.append(FK_FLOAT)
        elif ft.startswith("u") or ft.startswith("b"):
            kinds.append(FK_UHEX if gid_hex else FK_UDEC)
        else:
            kinds.append(FK_STR)
    nf = kinds.count(FK_FLOAT)
    nu = sum(1 for k in kinds if k in (FK_UDEC, FK_UHEX))
    ns = kinds.count(FK_STR)
    floats = np.zeros((nf, max_records), dtype=np.float64)
    uints = np.zeros((nu, max_records), dtype=np.uint64)
    strs = np.zeros((ns, max_records), dtype=f"S{_STR_WIDTH}")
    ckinds = (ctypes.c_int * len(kinds))(*kinds)
    n = lib.recio_parse(
        body, len(body), len(kinds), ckinds, max_records, _STR_WIDTH,
        floats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        uints.ctypes.data_as(ctypes.POINTER(ctypes.c_ulonglong)),
        strs.ctypes.data_as(ctypes.c_char_p))
    if n < 0:
        return None
    return n, kinds, floats[:, :n], uints[:, :n], strs[:, :n]


def format_records(gid: np.ndarray, strs: np.ndarray, floats: np.ndarray,
                   gid_hex: bool) -> bytes | None:
    """Format records for writing. strs: (ns, n) S16; floats: (nf, n)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(gid)
    ns, nf = strs.shape[0], floats.shape[0]
    gid = np.ascontiguousarray(gid, dtype=np.uint64)
    strs = np.ascontiguousarray(strs.astype(f"S{_STR_WIDTH}"))
    floats = np.ascontiguousarray(floats, dtype=np.float64)
    cap = n * (64 + ns * _STR_WIDTH + 24 * nf) + 1024
    out = ctypes.create_string_buffer(cap)
    w = lib.recio_format(
        n, gid.ctypes.data_as(ctypes.POINTER(ctypes.c_ulonglong)),
        1 if gid_hex else 0,
        strs.ctypes.data_as(ctypes.c_char_p), _STR_WIDTH, ns,
        floats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nf,
        out, cap)
    if w < 0:
        return None
    return out.raw[:w]


def crc32_rows(rows: "np.ndarray", skip: int = 0) -> "np.ndarray":
    """Per-row crc32 of rows[:, skip:] for (n, lrec) uint8 buffers.
    Native when the codec builds; zlib loop otherwise."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    n, lrec = rows.shape
    lib = get_lib()
    if lib is not None and hasattr(lib, "recio_crc32_rows"):
        import ctypes

        lib.recio_crc32_rows.restype = None
        lib.recio_crc32_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint32)]
        out = np.empty(n, dtype=np.uint32)
        lib.recio_crc32_rows(
            rows.ctypes.data_as(ctypes.c_char_p), n, lrec, skip,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return out
    import zlib

    return np.array([zlib.crc32(rows[i, skip:].tobytes()) & 0xFFFFFFFF
                     for i in range(n)], dtype=np.uint32)
