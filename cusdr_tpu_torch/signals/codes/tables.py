"""Loader for ICD constant tables stored as .npz archives.

See tools/extract_icd_tables.py for provenance: these are ICD-mandated
per-PRN constants (IS-GPS-200/705, Galileo OS SIS ICD, BDS-SIS-ICD), stored
as packed numpy data.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_DATA_DIR = Path(__file__).resolve().parent / "data"


@functools.lru_cache(maxsize=None)
def load_table(name: str):
    """Load data/<name>.npz (cached)."""
    path = _DATA_DIR / f"{name}.npz"
    if not path.exists():
        raise FileNotFoundError(
            f"ICD table archive {path} missing — run "
            "tools/extract_icd_tables.py")
    return np.load(path)
