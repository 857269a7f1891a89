"""Navigation-message codecs (decode + encode for test synthesis)."""

from .bits import bits_from_prompt, find_preamble  # noqa: F401
from . import lnav  # noqa: F401
