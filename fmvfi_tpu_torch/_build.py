"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every `*.cu` file under `csrc/` is compiled by its own `nvcc` process, all
started together, and the objects are linked into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), written
to `build/fmvfi_tpu_torch/` at the repository root under a name keyed by a
hash of the sources and flags: a second run with unchanged sources loads the
existing library instead of rebuilding.  The build happens at first use,
never at import.  `build(flags)` adds nvcc flags, for the kernels' diagnostic
forms (scripts/adacof_kernel_diagnostics.py); the package uses none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "fmvfi_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last nvcc run, if any

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
# name -> argtypes of each exported C function (tensor pointers and the
# stream as void*, the instantiation it reports as int*, sizes as int);
# restype is int (a cudaError_t) for all of them
_SIGNATURES = {
    "adacof_warp_fwd": [_P] * 7 + [_IP] + [_I] * 9,
    "adacof_warp_bwd": [_P] * 10 + [_IP] + [_I] * 9,
}


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
            "fmvfi_tpu_torch are built at first use and need the CUDA toolkit"
        )
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _library_path(flags: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfmvfi_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands as parallel processes, wait for every one, and raise
    RuntimeError with the stderr of those that failed."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cmd in cmds
    ]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(flags: tuple[str, ...] = ()) -> Path:
    """Compile the kernels, with nvcc's `flags` added, if no library for the
    current sources and flags exists; return the library's path.  Raises
    RuntimeError with nvcc's stderr if the build fails."""
    global build_seconds
    flags = tuple(flags)
    path = _library_path(flags)
    if path.exists():
        return path
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile and link in a private directory, then rename the library: a
    # reader never sees half a file
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in _sources()]
        _run_all([
            [nvcc, *NVCC_FLAGS, *flags, "-c", "-o", obj, str(src)]
            for obj, src in zip(objs, _sources())
        ])
        lib = os.path.join(tmp, path.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, path)
    build_seconds = time.perf_counter() - t0
    return path


def load(path: Path) -> ctypes.CDLL:
    """Load a library that `build` wrote, with argtypes set."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib
