"""A cell's records: its traffic file's skies (``traffic/skies/<sky>.py``),
synthesized on the device from the run's seed into interleaved I/Q of the
configuration's sample type (``traffic/samples/<data_type>.py``) held in
host memory."""

from __future__ import annotations

from ..traffic.codes import signal_of
from ..traffic.samples import sample_type
from ..traffic.skies import sky_of
from ..traffic.synth import make_record


def make_pool(config: dict, traffic: dict, seed: int, device):
    """[(iq, sky)] of the traffic's pool: one record for a geometric sky
    repeated, or ``pool`` distinct captures."""
    s = config["settings"]
    sig = signal_of(config["signal"])
    samples = sample_type(s["data_type"])
    make_sky = sky_of(traffic["sky"])
    fs = s["sampling_freq"]
    n = int(round(traffic["record_ms"] * fs * 1e-3))
    pool = []
    for j in range(traffic["pool"]):
        sky = make_sky(seed, j, config, traffic)
        iq = make_record(sig, sky.svs, fs, s["if_freq"], n,
                         (int(seed) * 1_000_003 + j) % (1 << 63), device,
                         samples)
        pool.append((iq, sky))
    return pool
