"""Build and bind the port's CUDA kernels.

At first use, ``nvcc`` compiles each ``csrc/<name>.cu`` for Hopper
(``sm_90a``) into a shared library of its own with a plain C interface, under
``_build/`` (listed in ``.gitignore``), and ``ctypes`` loads it; the
compilers of all sources that need building run at once.  A library's file
name carries a hash of its source, the shared headers and the flags, so an
edited source builds anew.  Importing
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
import time
from typing import Dict, Optional, Sequence

from trialign_torch.config import MAX_SUBMATRIX_SYMBOLS

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")

# -Xptxas -v puts each kernel's registers, shared memory and spills in the
# build log that chip_smoke.py prints.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Largest runtime submatrix every kernel takes: all that Scoring accepts,
# NCBI BLOSUM62's 24 symbols (csrc/plane_step.cuh kMaxSym holds the same
# number for the kernels).  The Pallas kernels of the reference stop at 8.
SUBMATRIX_NSYM_CAP = MAX_SUBMATRIX_SYMBOLS

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Source name -> seconds from the start of the build that compiled it to its
# nvcc's end (all of one build's compilers start together).
nvcc_seconds: Dict[str, float] = {}


class StepScoring(ctypes.Structure):
    """Mirror of ``trialign::StepScoring`` (csrc/plane_step.cuh)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "match", "mismatch", "gap_open", "gap_extend", "rtl", "nsym",
        "score_bits")]


class BlockedGeom(ctypes.Structure):
    """Mirror of ``trialign::BlockedGeom`` (csrc/blocked.cu)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "la", "hb", "wc", "n_jb", "n_kb", "nrows", "jlstar", "klstar", "d",
        "npack")]


class SlabGeom(ctypes.Structure):
    """Mirror of ``trialign::SlabGeom`` (csrc/slab.cu)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "la", "hb", "wc", "n_jb", "n_kb", "nrows", "variant")]


_P, _I, _IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
# Entry points of each kernel library: name -> (restype, argtypes).
SIGNATURES = {
    "wavefront": {
        "trialign_wavefront": (
            _I, [_P, _P, _P, _P, _P, _I, _I, _I, _P, StepScoring, _P, _P, _P,
                 _P, _P, _I, _I, _P]),
        "trialign_wavefront_resources": (_I, [_I, _I, _I, _I, _IP]),
    },
    "blocked": {
        "trialign_blocked_sweep": (
            _I, [_P, _P, _P, BlockedGeom, _P, _I, _P, StepScoring, _P, _P, _P,
                 _I, _I, _P, _P, _I, _P]),
        "trialign_blocked_resources": (_I, [_I, _I, _I, _I, _I, _I, _IP]),
    },
    "hetero": {
        "trialign_hetero_sweep": (
            _I, [_P, _P, _P, _I, _I, _I, _I, _P, StepScoring, _P, _P, _P, _P,
                 _P, _I, _I, _I, _P]),
        "trialign_hetero_resources": (_I, [_I, _I, _I, _I, _IP]),
        "trialign_hetero_phases": (
            _I, [ctypes.POINTER(ctypes.c_ulonglong)]),
    },
    "slab": {
        "trialign_slab_shared_bytes": (_I, [_I, _I, _I]),
        "trialign_slab_sweep": (
            _I, [_P, _P, _P, SlabGeom, _P, _I, _P, _P, StepScoring, _P, _P,
                 _P, _P, _I, _I, _P, _P, _I, _P]),
        "trialign_slab_resources": (_I, [_I, _I, _I, _I, _I, _IP]),
        "trialign_slab_choices": (
            _I, [_P, _P, _P, SlabGeom, _P, _P, StepScoring, _P, _P, _P, _P,
                 _P, _I, _I, _I, _P, _P, _P]),
    },
    "walk": {
        "trialign_walk": (_I, [_P, _P, _I, _I, _I, _I, _I, _P, _P]),
    },
    "vpu": {
        "trialign_vpu_threads": (_I, []),
        "trialign_vpu_blocks_per_sm": (_I, []),
        "trialign_vpu": (_I, [_P, _I, _I, _I, _I, _I, _P, _P]),
    },
}
SOURCES = tuple(SIGNATURES)


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu"),
                 *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
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


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    return os.path.join(BUILD_DIR, f"lib{name}_{_digest(name)}.so")


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile each named kernel source that has no library for its hash
    yet, one ``nvcc`` per source, all started together; returns the
    libraries' paths by name, and records in :data:`nvcc_seconds` the seconds
    from the start to each compiler's own end.  Raises RuntimeError without
    ``nvcc`` or when a compile fails, with the compiler's output."""
    paths = {name: library_path(name) for name in names}
    todo = [name for name in names if not os.path.exists(paths[name])]
    if not todo:
        return paths
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of trialign_torch build with "
            "the CUDA toolkit on a machine with an sm_90 GPU"
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    logs, threads = {}, []

    def wait(name, proc):
        # Each compiler's own end, whichever of them finishes first.
        logs[name] = proc.communicate()[0]
        nvcc_seconds[name] = time.perf_counter() - t0

    procs = {}
    for name in todo:
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        threads.append(threading.Thread(target=wait,
                                        args=(name, procs[name][2])))
        threads[-1].start()
    for thread in threads:
        thread.join()
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{logs[name]}")
            continue
        os.replace(tmp, paths[name])
        with open(paths[name] + ".log", "w") as f:
            f.write(logs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build_log() -> str:
    """The compiler's output for the current libraries (ptxas statistics)."""
    logs = []
    for name in SOURCES:
        try:
            with open(library_path(name) + ".log") as f:
                logs.append(f.read())
        except FileNotFoundError:
            pass
    return "".join(logs)


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed, load it, and declare its entry
    points' C types."""
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = ctypes.CDLL(build([name])[name])
        lib.trialign_error_string.restype = ctypes.c_char_p
        lib.trialign_error_string.argtypes = [_I]
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
        return lib


def kernels_take(scoring) -> bool:
    """Whether every kernel takes ``scoring``: match/mismatch, or a
    submatrix of at most SUBMATRIX_NSYM_CAP symbols.  The port's own gate
    for the kernel routes (``api.batch_routes``, ``api._route``); the
    reference's byte-packing gate ``plane_math.hetero_sub_ok`` does not
    bind K4 here."""
    return scoring.submatrix is None or \
        len(scoring.submatrix) <= SUBMATRIX_NSYM_CAP


def check_submatrix(scoring) -> None:
    """Raise ValueError for a submatrix past the kernels' table."""
    if not kernels_take(scoring):
        raise ValueError(
            f"submatrix alphabets beyond {SUBMATRIX_NSYM_CAP} symbols: "
            "use the 'golden'/'torch' backends"
        )


def step_scoring(scoring, score_bits: int):
    """(StepScoring, submatrix table as a host int32 array) for a launch.

    The table is the top-left (nsym+1)^2 corner of ``Scoring.sub_lookup()``:
    its last row and column hold the clamped floor that every code >= nsym
    scores, which is how the kernels index it; without a submatrix it is
    empty.  Raises ValueError for a submatrix past the kernels' table."""
    check_submatrix(scoring)
    nsym = 0 if scoring.submatrix is None else len(scoring.submatrix)
    table = scoring.sub_lookup()[: nsym + 1, : nsym + 1].copy() if nsym \
        else None
    step = StepScoring(
        scoring.match, scoring.mismatch, scoring.gap_open, scoring.gap_extend,
        int(scoring.s3_mode == "rtl"), nsym, score_bits,
    )
    return step, table


def kernel_scoring(scoring, score_bits: int, device):
    """(StepScoring, submatrix table on ``device``) for a launch
    (:func:`step_scoring`); without a submatrix the table is a one-int
    placeholder the kernels do not read.  A submatrix's table is built and
    copied to ``device`` inside the span ``sub_table``."""
    import torch

    from trialign_torch.metrics import span

    if scoring.submatrix is None:
        step, _ = step_scoring(scoring, score_bits)
        return step, torch.zeros(1, dtype=torch.int32, device=device)
    with span("sub_table"):
        step, table = step_scoring(scoring, score_bits)
        return step, torch.from_numpy(table).to(device)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.trialign_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
