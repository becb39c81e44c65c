"""Optical-flow and image file I/O — pure numpy.  The port's own copy of
``vst_tpu/data/flowio.py`` (the port imports nothing of the JAX package);
PIL is imported only where an image is read or written.

Formats (parity: ReCoNet/flowlib.py:14-187, byte-identical in RTNSTV):
- ``.flo``    — Middlebury "PIEH" float32 flow (readFlow:100-115)
- ``.pfm``    — portable float map, bottom-up scanlines (readPFM:34-69);
  reading a ``.pfm`` as flow keeps channels 0:2
- ``.float3`` — Freiburg float blob (readFloat:140-160)
- ``.ppm/.pgm/.png/.jpg`` — via PIL
- Sintel ``.flo`` with the 202021.25 sanity tag
  (RTNSTV/utilities.py:113-152 ``read_sintel_flow``)
"""

import os
import re

import numpy as np

_PIEH = b"PIEH"
_SINTEL_TAG = 202021.25


def read(path: str) -> np.ndarray:
    """Dispatch on extension (flowlib.read parity)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".float3":
        return read_float3(path)
    if ext == ".flo":
        return read_flo(path)
    if ext in (".ppm", ".pgm", ".png", ".jpg"):
        return read_image(path)
    if ext == ".pfm":
        return read_pfm(path)[0]
    raise ValueError(f"don't know how to read {path}")


def write(path: str, data: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flo":
        return write_flo(path, data)
    if ext == ".pfm":
        return write_pfm(path, data)
    if ext in (".ppm", ".pgm", ".png", ".jpg"):
        return write_image(path, data)
    raise ValueError(f"don't know how to write {path}")


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    with open(path, "rb") as f:
        header = f.readline().rstrip().decode("ascii")
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("ascii"))
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, dims.groups())
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    if image.dtype != np.float32:
        raise ValueError("PFM image dtype must be float32")
    color = image.ndim == 3 and image.shape[2] == 3
    if not color and not (image.ndim == 2 or
                          (image.ndim == 3 and image.shape[2] == 1)):
        raise ValueError("PFM image must be HxWx3, HxWx1 or HxW")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())  # little-endian
        np.flipud(image).astype("<f4").tofile(f)


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo (also accepts .pfm flow, keeping 2 channels)."""
    if path.lower().endswith(".pfm"):
        return read_pfm(path)[0][:, :, 0:2]
    with open(path, "rb") as f:
        if f.read(4) != _PIEH:
            raise ValueError(f"{path}: missing PIEH header")
        width = int(np.fromfile(f, np.int32, 1)[0])
        height = int(np.fromfile(f, np.int32, 1)[0])
        flow = np.fromfile(f, np.float32, width * height * 2)
    return flow.reshape(height, width, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(_PIEH)
        np.array([flow.shape[1], flow.shape[0]], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_sintel_flo(path: str) -> np.ndarray:
    """Sintel .flo with the 202021.25 float tag check
    (RTNSTV/utilities.py:113-152)."""
    with open(path, "rb") as f:
        tag = np.fromfile(f, np.float32, 1)[0]
        if abs(tag - _SINTEL_TAG) > 1e-3:
            raise ValueError(f"{path}: bad Sintel tag {tag}")
        width = int(np.fromfile(f, np.int32, 1)[0])
        height = int(np.fromfile(f, np.int32, 1)[0])
        flow = np.fromfile(f, np.float32, width * height * 2)
    return flow.reshape(height, width, 2)


def read_float3(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.readline().decode("utf-8") != "float\n":
            raise ValueError(f"{path}: missing float keyword")
        dim = int(f.readline())
        dims = [int(f.readline()) for _ in range(dim)]
        dims = list(reversed(dims))
        count = int(np.prod(dims))
        data = np.fromfile(f, np.float32, count).reshape(dims)
    if dim > 2:
        data = np.transpose(data, (2, 1, 0))
        data = np.transpose(data, (1, 0, 2))
    return data


def read_image(path: str) -> np.ndarray:
    from PIL import Image

    if path.lower().endswith(".pfm"):
        data = read_pfm(path)[0]
        return data[:, :, 0:3] if data.ndim == 3 else data
    return np.asarray(Image.open(path))


def write_image(path: str, data: np.ndarray) -> None:
    from PIL import Image

    if path.lower().endswith(".pfm"):
        return write_pfm(path, data)
    Image.fromarray(data).save(path)
