"""Record sample types by the name a configuration's ``data_type`` gives
(the receiver's own names): ``<name>.py`` holds ``DTYPE`` (numpy) and
``quantize(i, q)``, the interleaved samples of float I and Q as a tensor
of that type."""

import importlib


def sample_type(name: str):
    """The module of sample type ``name``."""
    return importlib.import_module(f"{__name__}.{name}")
