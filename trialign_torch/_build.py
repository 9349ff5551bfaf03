"""Build and bind the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, under ``_build/`` (listed
in ``.gitignore``), and ``ctypes`` loads it.  The library's file name carries
a hash of the sources and flags, so an edited source builds anew.  Importing
this module needs no toolchain: a machine without ``nvcc`` fails when a kernel
is first launched, not before.

The counterpart of ``trialign/native/build.py`` for the C++ oracle.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")

# -Xptxas -v puts each kernel's registers, shared memory and spills in the
# build log that chip_smoke.py prints.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Largest runtime submatrix the kernels take (csrc/plane_step.cuh kMaxSym),
# the Pallas kernels' cap (trialign/kernels/wavefront.py SUBMATRIX_NSYM_CAP).
SUBMATRIX_NSYM_CAP = 8

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class StepScoring(ctypes.Structure):
    """Mirror of ``trialign::StepScoring`` (csrc/plane_step.cuh)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "match", "mismatch", "gap_open", "gap_extend", "rtl", "nsym",
        "score_bits")]


class BlockedGeom(ctypes.Structure):
    """Mirror of ``trialign::BlockedGeom`` (csrc/blocked.cu)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "la", "hb", "wc", "n_jb", "n_kb", "nrows", "jlstar", "klstar")]


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def nvcc_path() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libtrialign_torch_{_digest()}.so")


def build() -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library's path.  Raises RuntimeError without ``nvcc`` or when the
    compile fails, with the compiler's output."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of trialign_torch build with "
            "the CUDA toolkit on a machine with an sm_90 GPU"
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    with open(path + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    return path


def build_log() -> str:
    """The compiler's output for the current library (ptxas statistics)."""
    try:
        with open(library_path() + ".log") as f:
            return f.read()
    except FileNotFoundError:
        return ""


def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C types."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.trialign_error_string.restype = ctypes.c_char_p
        lib.trialign_error_string.argtypes = [i]
        lib.trialign_wavefront_scratch_ints.restype = i
        lib.trialign_wavefront_scratch_ints.argtypes = [i, i]
        lib.trialign_wavefront.restype = i
        lib.trialign_wavefront.argtypes = [
            p, i, p, p, p, i, i, i, p, StepScoring, p, p, i, p]
        lib.trialign_blocked_diag.restype = i
        lib.trialign_blocked_diag.argtypes = [
            p, p, p, BlockedGeom, i, p, StepScoring, p, p, p, i, p]
        _lib = lib
        return lib


def check_submatrix(scoring) -> None:
    """Raise ValueError for a submatrix the kernels do not take."""
    if scoring.submatrix is not None and \
            len(scoring.submatrix) > SUBMATRIX_NSYM_CAP:
        raise ValueError(
            f"submatrix alphabets beyond {SUBMATRIX_NSYM_CAP} symbols: "
            "use the 'golden'/'torch' backends"
        )


def kernel_scoring(scoring, score_bits: int, device):
    """(StepScoring, submatrix table on ``device``) for a launch.

    The table is the top-left (nsym+1)^2 corner of ``Scoring.sub_lookup()``:
    its last row and column hold the clamped floor that every code >= nsym
    scores, which is how the kernels index it.  Without a submatrix it is a
    one-int placeholder the kernels do not read."""
    import torch

    check_submatrix(scoring)
    nsym = 0 if scoring.submatrix is None else len(scoring.submatrix)
    if nsym:
        table = torch.from_numpy(
            scoring.sub_lookup()[: nsym + 1, : nsym + 1].copy()
        ).to(device)
    else:
        table = torch.zeros(1, dtype=torch.int32, device=device)
    step = StepScoring(
        scoring.match, scoring.mismatch, scoring.gap_open, scoring.gap_extend,
        int(scoring.s3_mode == "rtl"), nsym, score_bits,
    )
    return step, table


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.trialign_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
