"""ctypes binding to the native flow-I/O library (``native/vstio.cc``,
built by ``make -C native``).  Counterpart of ``vst_tpu/data/native.py``.

Reads through the port's numpy readers (``data/flowio.py``) while the
library is not built or is older than its source; both give the same
bits.  Host I/O only, never the device.
"""

import ctypes
import functools
import os

import numpy as np

from vst_tpu_torch.data import flowio

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvstio.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "vstio.cc")


def _load():
    """The library, or None while it is missing or older than its source
    (checked on every call: it may be built later in the process)."""
    if not os.path.exists(_LIB_PATH):
        return None
    if (os.path.exists(_SRC_PATH)
            and os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH)):
        return None  # stale: it would read with outdated behaviour
    return _open_lib(_LIB_PATH)


@functools.cache
def _open_lib(path):
    lib = ctypes.CDLL(path)
    lib.vstio_pfm_header.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double)]
    lib.vstio_pfm_header.restype = ctypes.c_int
    lib.vstio_read_pfm.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.vstio_read_pfm.restype = ctypes.c_int
    lib.vstio_flo_header.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.vstio_flo_header.restype = ctypes.c_int
    lib.vstio_read_flo.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.vstio_read_flo.restype = ctypes.c_int
    lib.vstio_read_flow_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64]
    lib.vstio_read_flow_batch.restype = ctypes.c_int
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_pfm(path: str) -> np.ndarray:
    """(H, W[, 3]) float32, top-down rows — matches flowio.read_pfm data."""
    lib = _load()
    if lib is None:
        return flowio.read_pfm(path)[0].astype(np.float32)
    h = ctypes.c_int64()
    w = ctypes.c_int64()
    ch = ctypes.c_int64()
    scale = ctypes.c_double()
    rc = lib.vstio_pfm_header(path.encode(), ctypes.byref(h), ctypes.byref(w),
                              ctypes.byref(ch), ctypes.byref(scale))
    if rc != 0:
        raise IOError(f"vstio_pfm_header({path}) failed: {rc}")
    shape = (h.value, w.value, ch.value) if ch.value == 3 else (h.value, w.value)
    out = np.empty(shape, np.float32)
    rc = lib.vstio_read_pfm(path.encode(), _fptr(out), out.size)
    if rc != 0:
        raise IOError(f"vstio_read_pfm({path}) failed: {rc}")
    return out


def read_flo(path: str) -> np.ndarray:
    lib = _load()
    if lib is None:
        return flowio.read_flo(path)
    h = ctypes.c_int64()
    w = ctypes.c_int64()
    rc = lib.vstio_flo_header(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"vstio_flo_header({path}) failed: {rc}")
    out = np.empty((h.value, w.value, 2), np.float32)
    rc = lib.vstio_read_flo(path.encode(), _fptr(out), out.size)
    if rc != 0:
        raise IOError(f"vstio_read_flo({path}) failed: {rc}")
    return out


def read_flow_batch(paths: list[str], shape: tuple,
                    num_threads: int = 8) -> np.ndarray:
    """Decode N same-shaped flow files into one (N, *shape) float32 array
    using the native thread pool (falls back to a Python loop)."""
    kind = 0 if paths[0].endswith(".pfm") else 1
    lib = _load()
    per = int(np.prod(shape))
    out = np.empty((len(paths),) + tuple(shape), np.float32)
    if lib is None:
        for i, p in enumerate(paths):
            out[i] = read_pfm(p) if kind == 0 else read_flo(p)
        return out
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    rc = lib.vstio_read_flow_batch(blob, len(paths), kind, _fptr(out), per,
                                   num_threads)
    if rc != 0:
        raise IOError(f"vstio_read_flow_batch failed: {rc}")
    return out
