"""A geometric GPS sky with LNAV frames: ``n_svs`` SVs at ``cn0_dbhz``
over ``record_ms``, ``nav_frames`` frames; one sky per seed."""

from ..scenario import gps_sky


def make(seed: int, capture: int, config: dict, traffic: dict):
    return gps_sky(seed, fs=config["settings"]["sampling_freq"],
                   n_svs=traffic["n_svs"],
                   duration_s=traffic["record_ms"] * 1e-3,
                   cn0_dbhz=traffic["cn0_dbhz"],
                   nav_frames=traffic["nav_frames"])
