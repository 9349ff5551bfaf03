"""Sequence IO (the port's copy of ``trialign/io/datasets.py``): .dat test vectors (one integer symbol per line, the format of
the reference repo's dat/A_seq.dat etc.) and FASTA files.

The reference's dat/ triplet (64 random symbols over {0..3} per sequence)
is adopted as this framework's canonical short test vector
(reference: dat/A_seq.dat:1-64; SURVEY.md section 0.3 item 5).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

# Bundled verbatim copies of the reference's dat/ test vectors (see
# data/README.md); data/alt/ holds this repo's own second fixture triplet.
_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def load_dat_sequence(path: str) -> np.ndarray:
    """Load a .dat sequence file: one integer symbol code per line."""
    with open(path) as f:
        vals = [int(line.strip()) for line in f if line.strip()]
    arr = np.array(vals, dtype=np.uint8)
    if arr.size and arr.max() > 4:
        raise ValueError(f"{path}: symbol codes must be in [0, 4]")
    return arr


def load_reference_triplet(data_dir: str | None = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load the canonical (A, B, C) short test triplet.

    Looks in ``data_dir`` if given, else the bundled copy.
    """
    candidates = []
    if data_dir:
        candidates.append(data_dir)
    candidates.append(_DATA_DIR)
    for d in candidates:
        pa = os.path.join(d, "A_seq.dat")
        if os.path.exists(pa):
            return (
                load_dat_sequence(pa),
                load_dat_sequence(os.path.join(d, "B_seq.dat")),
                load_dat_sequence(os.path.join(d, "C_seq.dat")),
            )
    raise FileNotFoundError("A_seq/B_seq/C_seq .dat files not found")


def load_alt_triplet() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load the repo's own second 64-symbol fixture triplet (data/alt/)."""
    return load_reference_triplet(os.path.join(_DATA_DIR, "alt"))


def read_fasta(path: str) -> Dict[str, str]:
    """Minimal FASTA reader returning {name: sequence}."""
    seqs: Dict[str, List[str]] = {}
    name = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                name = line[1:].split()[0]
                seqs[name] = []
            else:
                if name is None:
                    raise ValueError(f"{path}: sequence data before first header")
                seqs[name].append(line.upper())
    return {k: "".join(v) for k, v in seqs.items()}
