"""Jax-free view of the reference package's numpy host layers.

``cusdr_tpu/__init__.py`` imports jax, so ``import cusdr_tpu.config`` needs
jax even though ``config`` itself does not.  This package sets its
``__path__`` to the ``cusdr_tpu/`` directory: ``cusdr_tpu_torch.host.X``
loads ``cusdr_tpu/X.py`` as a module of this package, its relative imports
resolve inside this package, and ``cusdr_tpu/__init__.py`` never runs.  The
port reuses these modules without copying them:

  config, constants, signals.*, io.{ingest, synth, scenario}, nav.*,
  pvt.*, geodesy.*, orbits.*, runtime (the native ingest library)

Not reachable through this view (their package ``__init__`` imports jax):
``tracking``, ``acquisition``, ``ops``, ``parallel``, ``receiver`` and
``nav.dispatch.decode_lnav`` (which imports ``receiver``).  The port keeps
numpy copies of ``tracking.cno``, ``tracking.loop_filters``,
``tracking.qmboc`` and ``acquisition.resample``, and its own
``receiver.decode_nav_channel``.
"""

import os as _os

__path__ = [_os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__)))), "cusdr_tpu")]
