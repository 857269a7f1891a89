"""Sample ingest and synthetic IF generation."""

from .ingest import load_if_samples, read_if_file, unpack_2bit_iq  # noqa: F401
from .synth import SynthSV, synthesize_if, write_if_file  # noqa: F401
