"""A geometric Galileo sky of the configuration's PRNs with F/NAV pages:
``n_svs`` SVs at ``cn0_dbhz`` over ``record_ms``, ``nav_pages`` pages;
one sky per seed."""

from ..scenario import galileo_sky


def make(seed: int, capture: int, config: dict, traffic: dict):
    s = config["settings"]
    return galileo_sky(seed, fs=s["sampling_freq"], n_svs=traffic["n_svs"],
                       duration_s=traffic["record_ms"] * 1e-3,
                       cn0_dbhz=traffic["cn0_dbhz"],
                       prns=s["acq_satellite_list"],
                       nav_pages=traffic["nav_pages"])
