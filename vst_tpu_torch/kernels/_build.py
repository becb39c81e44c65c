"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/vst_tpu_torch/`` at the
root of the checkout and loaded with ctypes.  A library older than any
source in ``csrc/`` is rebuilt.  There is no prebuilt binary and no
fallback: without ``nvcc`` the build raises.

``build_all()`` starts one ``nvcc`` per source at once and waits for all
of them, so the build takes as long as the slowest file.
"""

import ctypes
import fcntl
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "vst_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNELS = ("res_block", "head_conv", "adaattn_fwd", "adaattn_bwd")

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # nvcc's output (ptxas register/spill report)


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME (default /usr/local/cuda), else from PATH."""
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of vst_tpu_torch are built from source at first "
            "use and need the CUDA toolkit")
    return found


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(os.path.join(CSRC, f))
                 for f in os.listdir(CSRC))
    return os.path.getmtime(lib) < newest


def build_all(names=KERNELS) -> float:
    """Compile every stale kernel library, all ``nvcc``s in parallel.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in names if _stale(n)]
        if todo:
            nvcc = find_nvcc()
            procs = {}
            for n in todo:
                tmp = _lib_path(n) + f".{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
                       os.path.join(CSRC, f"{n}.cu")]
                procs[n] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for n, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                build_log[n] = out
                if proc.returncode != 0:
                    failed.append(f"--- {n}.cu (rc {proc.returncode})\n{out}")
                else:
                    os.replace(tmp, _lib_path(n))
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>.so``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(_lib_path(name))
        _loaded[name] = lib
    return lib
