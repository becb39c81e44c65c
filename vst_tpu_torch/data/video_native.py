"""ctypes binding to the native MJPG/AVI decoder (``native/vstvideo.cc``,
built by ``make -C native``).

Counterpart of ``vst_tpu/data/video_native.py``: the library indexes the
AVI container once and decodes batches of JPEG frames on a thread pool.
``open_video`` returns None when the library is not built, or is older
than its source, or the file is not an MJPG AVI; callers then decode with
cv2.  This is about the host decoder only, never about the device.
"""

import ctypes
import functools
import os

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvstvideo.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "vstvideo.cc")


def _load():
    """The library, or None while it is missing or older than its source
    (checked on every call: it may be built later in the process)."""
    if not os.path.exists(_LIB_PATH):
        return None
    if (os.path.exists(_SRC_PATH)
            and os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH)):
        return None  # stale: it would decode with outdated behaviour
    return _open_lib()


@functools.cache
def _open_lib():
    lib = ctypes.CDLL(_LIB_PATH)
    lib.vstvideo_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.vstvideo_open.restype = ctypes.c_int64
    lib.vstvideo_read_batch.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.vstvideo_read_batch.restype = ctypes.c_int
    lib.vstvideo_close.argtypes = [ctypes.c_int64]
    lib.vstvideo_close.restype = None
    return lib


def available() -> bool:
    return _load() is not None


class NativeMJPGVideo:
    """Random-access MJPG AVI reader with thread-pool batch decode."""

    def __init__(self, path: str, num_threads: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("libvstvideo.so not built (make -C native)")
        n, h, w = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        handle = lib.vstvideo_open(path.encode(), ctypes.byref(n),
                                   ctypes.byref(h), ctypes.byref(w))
        if handle <= 0:
            raise IOError(f"vstvideo_open({path}) failed: {handle} "
                          "(not an MJPG AVI?)")
        self._lib = lib
        self._handle = handle
        self.n_frames, self.height, self.width = n.value, h.value, w.value
        self.num_threads = num_threads

    def read_batch(self, start: int, count: int) -> np.ndarray:
        """(count, H, W, 3) RGB uint8."""
        out = np.empty((count, self.height, self.width, 3), np.uint8)
        rc = self._lib.vstvideo_read_batch(
            self._handle, start, count,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.num_threads)
        if rc != 0:
            raise IOError(f"vstvideo_read_batch failed: {rc}")
        return out

    def frames(self, batch_size: int = 8, resize_wh=None,
               interpolation="linear"):
        """Yield HWC RGB uint8 frames, ``batch_size`` decoded at a time;
        the optional resize matches ``infer.video.frames_from_video``."""
        resize = (resize_wh is not None
                  and tuple(resize_wh) != (self.width, self.height))
        if resize:
            import cv2

            interp = {"linear": cv2.INTER_LINEAR,
                      "area": cv2.INTER_AREA}[interpolation]
        for start in range(0, self.n_frames, batch_size):
            batch = self.read_batch(start, min(batch_size,
                                               self.n_frames - start))
            for frame in batch:
                if resize:
                    frame = cv2.resize(frame, tuple(resize_wh),
                                       interpolation=interp)
                yield frame

    def close(self):
        if self._handle:
            self._lib.vstvideo_close(self._handle)
            self._handle = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_video(path: str, num_threads: int = 8):
    """A NativeMJPGVideo when possible, else None (decode with cv2)."""
    if not available():
        return None
    try:
        return NativeMJPGVideo(path, num_threads)
    except IOError:
        return None
