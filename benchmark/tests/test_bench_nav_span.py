"""``nav_diff`` judges a channel over its own span: one E5a channel of a
60.5 s record, built by hand from F/NAV pages of a sky that sent an
ephemeris, through ``check_record`` with the record's acquisition, the
loop rules' chain and the recomputation stood in for (the recomputation
returns the channel's own sums, against a noise of 1 a sum).

A channel the program drops before ``ALWAYS`` epochs with no decode is no
missing decode; kept to the end, or dropped past ``ALWAYS`` with a wrong
decode, it is one; a decode from a span under ``NEVER`` counts; and a
drop of a channel that still holds lock is refused by ``trk_lock_diff``.
Also: the cell ``e5a_60s`` is the gal_e5a_lockgate configuration."""

from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
N_EP = 60_497                 # epochs an e5a_60s record tracks
K0 = 3_507                    # code periods of the stream before epoch 0
T0 = 345_600.0                # signal time of the stream's start [s]
PRN = 11
SUMS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l")
FIELDS = SUMS + ("carr_freq", "code_freq", "rem_code_phase",
                 "rem_carr_phase")


@pytest.fixture(scope="module")
def e5a():
    from benchmark.harness import cells
    cell = cells.find_cell(ROOT, "e5a_60s")
    return cell.config["settings"], cell.config["signal"], cell.limits


def _truth():
    from benchmark.traffic.scenario import make_gal_eph
    return make_gal_eph(PRN, T0, m0=0.3, omega0=-1.1)


def _channel(s, g, until, tail_locked, pages):
    """The plain program outputs of one channel tracked ``until`` epochs of
    ``N_EP``: prompts in phase lock (amplitude 10, with the F/NAV symbols
    of ``pages`` times the CS20 code, or a constant sign where ``pages``
    is None), their last 64 epochs in lock or noise; zero past ``until``,
    except that "beyond" pages carry on in the prompts past the span."""
    from benchmark.frozen.codes import E5AI_SECONDARY
    from benchmark.traffic.scenario import fnav_stream
    rng = np.random.default_rng(until + 7 * int(tail_locked))
    spc = int(round(s["sampling_freq"] * 1e-3))
    k = K0 + np.arange(N_EP)
    sign = np.ones(N_EP)
    if pages is not None:
        eph = _truth()
        if pages == "wrong":
            eph["M_0"] += 1e-3
        sym = fnav_stream(eph, T0, 16).astype(np.float64)
        sign = sym[k // 20] * E5AI_SECONDARY[k % 20]
    i_p = 10.0 * sign + rng.normal(0, 0.3, N_EP)
    q_p = rng.normal(0, 0.3, N_EP)
    if not tail_locked:
        i_p[until - 64:until] = rng.normal(0, 1, 64)
        q_p[until - 64:until] = rng.normal(0, 1, 64)
    end = N_EP if pages == "beyond" else until
    i_p[end:] = q_p[end:] = 0.0
    trk = {nm: np.zeros((1, N_EP)) for nm in FIELDS}
    trk["i_p"][0], trk["q_p"][0] = i_p, q_p
    trk["carr_freq"][:] = s["if_freq"]
    trk["code_freq"][:] = g["chip_rate_hz"]
    trk["abs_sample"] = (np.arange(N_EP, dtype=np.int64) * spc)[None]
    trk["blksize"] = np.where(np.arange(N_EP) < until, spc, 0)[None]
    trk["prns"] = np.asarray([PRN])
    trk["active_until"] = np.asarray([until])
    acq = dict(prns=np.asarray([PRN]), peak_metric=np.asarray([20.0]),
               detected=np.asarray([True]), code_phase=np.asarray([0]),
               carr_freq=np.asarray([s["if_freq"]]),
               coarse_freq=np.asarray([s["if_freq"]]))
    return dict(acq=acq, channels=[(PRN, s["if_freq"], 0)], track=trk,
                fixes={})


def _judge(monkeypatch, s, g, prog):
    """``check_record``'s numbers of ``prog`` against a sky that sent the
    truth's pages; the acquisition agrees and the recomputation returns
    the program's own sums."""
    from benchmark.reference import acquisition, check, tracking
    from benchmark.reference.precision import REFERENCE
    from benchmark.traffic.scenario import Sky
    from benchmark.traffic.synth import SV
    trk = prog["track"]

    def recompute(iq, trk, chan, ep, tables, s, g, device, prec):
        r = {nm: trk[nm][chan, ep] for nm in SUMS}
        return dict(r, bsz=trk["blksize"][chan, ep],
                    noise=np.ones(len(chan)),
                    carr_next=trk["carr_freq"][chan, ep + 1],
                    code_next=trk["code_freq"][chan, ep + 1],
                    rem_code_next=trk["rem_code_phase"][chan, ep + 1],
                    rem_carr_next=trk["rem_carr_phase"][chan, ep + 1])

    monkeypatch.setattr(acquisition, "acquire", lambda *a: None)
    monkeypatch.setattr(acquisition, "best_prns", lambda acq, n: [PRN])
    monkeypatch.setattr(check, "_acq_numbers", lambda *a: (0, 0.0))
    monkeypatch.setattr(check, "chain_gaps", lambda *a: dict(
        geom=0, phase=0.0, carr=0.0, code=0.0))
    monkeypatch.setattr(tracking, "tables_for", lambda *a: None)
    monkeypatch.setattr(tracking, "recompute", recompute)
    spc = int(round(s["sampling_freq"] * 1e-3))
    sky = Sky(svs=[SV(prn=PRN, code_phase=-float(K0 * spc), doppler_hz=0.0,
                      cn0_dbhz=50.0)],
              rx_ecef=np.zeros(3), frame_t0=T0, eph_by_prn={PRN: _truth()})
    out, info = check.check_record(None, prog, sky, s, g, None, "cpu",
                                   REFERENCE, np.random.default_rng(5))
    return out, info


@pytest.mark.parametrize(
    "until, tail_locked, pages, nav_diff, lock_diff",
    [(3_000, False, None, 0, 0),
     (N_EP, True, None, 1, 0),
     (53_000, False, "wrong", 1, 0),
     (53_000, False, "right", 0, 0),
     (N_EP, True, "right", 0, 0),
     (20_000, False, "beyond", 1, 0),
     (3_000, True, None, 0, 1)],
    ids=["dropped_before_always_no_decode", "kept_to_the_end_no_decode",
         "dropped_past_always_wrong_decode",
         "dropped_past_always_right_decode", "kept_right_decode",
         "decode_beyond_a_span_under_never", "dropped_holding_lock"])
def test_nav_diff_counts_over_the_channel_span(monkeypatch, e5a, until,
                                               tail_locked, pages,
                                               nav_diff, lock_diff):
    from benchmark.reference.codecs import fnav
    assert until < fnav.NEVER or until >= fnav.ALWAYS
    s, g, limits = e5a
    out, info = _judge(monkeypatch, s, g, _channel(s, g, until, tail_locked,
                                                   pages))
    assert out["nav_diff"] == nav_diff
    assert out["trk_lock_diff"] == lock_diff
    assert info["decoded"] == int(pages in ("right", "wrong"))
    over = {k for k, v in out.items() if not v <= limits[k]}
    assert over == ({"nav_diff"} if nav_diff else set()) | (
        {"trk_lock_diff"} if lock_diff else set())


def test_the_e5a_60s_cell_runs_the_lockgate_configuration():
    import json
    from benchmark.harness import cells
    cell = cells.find_cell(ROOT, "e5a_60s")
    assert cell.config_name == "gal_e5a_lockgate" and cell.chips == 1
    assert cell.config == json.loads(
        (BENCH / "configs/gal_e5a_lockgate.json").read_text())
    assert cell.traffic["config"] == "gal_e5a_lockgate"
    assert (cell.traffic["sky"], cell.traffic["n_svs"],
            cell.traffic["record_ms"], cell.traffic["nav_pages"],
            cell.traffic["pool"], cell.traffic["check_records"]) == (
        "galileo", 12, 60_500, 16, 1, 1)
    assert {m["name"] for m in cell.per_layer} >= {
        "nav_fec_s", "s1p_roofline", "trk_lock_drops", "nav_decode_s",
        "pvt_s", "acq_fine_rows", "acq_codes_hit"}
    assert {m["name"] for m in cell.end_to_end} == {"realtime_x",
                                                    "setup_s"}
    fec = {m["name"]: m for m in cell.per_layer}["nav_fec_s"]
    assert fec == {"name": "nav_fec_s", "unit": "s", "better": "lower",
                   "source": "program_span",
                   "layer": "navigation and PVT (receiver.nav_solve, nav/, "
                            "pvt/)",
                   "moves": "realtime_x", "workloads": ["e5a_60s"]}
