"""A snapshot sky: ``n_svs`` distinct PRNs of the configuration at random
code phases, Dopplers within +-``doppler_hz`` and random nav symbols at
``cn0_dbhz``; a distinct sky per capture."""

from ..scenario import snapshot_sky


def make(seed: int, capture: int, config: dict, traffic: dict):
    s, g = config["settings"], config["signal"]
    spc = int(round(s["sampling_freq"]
                    / (g["chip_rate_hz"] / g["code_length_chips"])))
    return snapshot_sky(seed, capture, samples_per_code=spc,
                        prns=s["acq_satellite_list"],
                        n_svs=traffic["n_svs"],
                        cn0_dbhz=traffic["cn0_dbhz"],
                        seconds=traffic["record_ms"] * 1e-3,
                        nav_symbol_ms=g["nav_symbol_ms"],
                        doppler_hz=traffic["doppler_hz"])
