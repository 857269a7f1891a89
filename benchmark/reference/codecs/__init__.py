"""Nav message codecs by the name a configuration's ``signal.nav_codec``
gives: ``<name>.py`` holds ``decode(i_p, ms_per_bit) -> (eph, start
epoch, TOW)`` (or (None, -1, inf)), ``broadcast(eph, tow) -> eph`` (what a
receiver decodes of what was sent), ``pos(t, eph) -> (xyz, clock)`` (the
orbit model), ``NEVER`` and ``ALWAYS`` (the epochs below which a record
holds no whole message, and from which it always holds one) and ``SKIP``
(fields not compared).  Only records whose sky sent ephemerides look up
a codec."""

import importlib


def codec_of(name: str):
    """The module of nav codec ``name``."""
    return importlib.import_module(f"{__name__}.{name}")
