"""Code generators by signal, found by the name a configuration's
``signal.codes`` gives: ``<name>.py`` holds ``signal(g) -> Signal``."""

import importlib


def signal_of(g: dict):
    """The synthesizer's ``Signal`` for a configuration's signal section."""
    mod = importlib.import_module(f"{__name__}.{g['codes']}")
    return mod.signal(g)
