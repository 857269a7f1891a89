"""Sky builders by name, found by the name a traffic file's ``sky`` gives:
``<name>.py`` holds ``make(seed, capture, config, traffic) -> Sky``, the
sky of capture ``capture`` of the pool of ``seed``."""

import importlib


def sky_of(name: str):
    """``make`` of the sky builder ``name``."""
    return importlib.import_module(f"{__name__}.{name}").make
