"""Presentation layer: signal probe, acquisition/tracking/navigation plots,
sky plot and channel status table.

Equivalents of the reference L0 layer (GPS/GPS_L1CA/include/probeData.m,
plotAcquisition.m, plotTracking.m, plotNavigation.m, skyPlot.m,
showChannelStatus.m), rendered with matplotlib (Agg-safe: every function
returns the Figure; callers save or show)."""

from __future__ import annotations

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def probe_data(samples: np.ndarray, cfg, max_ms: float = 10.0):
    """Time-domain, spectrum and histogram pre-flight checks
    (probeData.m:100-170).

    samples: complex (I/Q) or real IF samples.
    """
    fs = cfg.sampling_freq
    n = min(len(samples), int(fs * max_ms * 1e-3))
    x = np.asarray(samples[:n])
    is_complex = np.iscomplexobj(x)

    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    t_ms = np.arange(min(n, int(fs * 5e-4))) / fs * 1e3
    ax = axes[0, 0]
    if is_complex:
        ax.plot(t_ms, x.real[:len(t_ms)], label="I")
        ax.plot(t_ms, x.imag[:len(t_ms)], label="Q")
        ax.legend()
    else:
        ax.plot(t_ms, x[:len(t_ms)])
    ax.set_xlabel("time [ms]")
    ax.set_title("Time domain")

    # Welch-style averaged periodogram (probeData.m:128-131)
    ax = axes[0, 1]
    seg = 2048
    nseg = max(n // seg, 1)
    win = np.hanning(seg)
    psd = np.zeros(seg)
    for k in range(nseg):
        blk = x[k * seg:(k + 1) * seg]
        if len(blk) < seg:
            break
        psd += np.abs(np.fft.fft(blk * win)) ** 2
    psd /= max(nseg, 1)
    freqs = np.fft.fftfreq(seg, 1 / fs)
    order = np.argsort(freqs)
    ax.plot(freqs[order] / 1e6, 10 * np.log10(psd[order] + 1e-12))
    ax.set_xlabel("frequency [MHz]")
    ax.set_title("Power spectral density")

    ax = axes[1, 0]
    ax.hist(x.real, bins=np.arange(-130, 131) if np.ptp(x.real) > 20
            else 31, density=True)
    ax.set_title("Histogram (I)" if is_complex else "Histogram")
    if is_complex:
        ax = axes[1, 1]
        ax.hist(x.imag, bins=31, density=True)
        ax.set_title("Histogram (Q)")
    else:
        axes[1, 1].axis("off")
    fig.tight_layout()
    return fig


def plot_acquisition(acq_result):
    """Bar plot of the acquisition metric per PRN
    (plotAcquisition.m:41)."""
    fig, ax = plt.subplots(figsize=(10, 4))
    prns = acq_result.prns
    colors = ["tab:green" if d else "tab:gray"
              for d in acq_result.detected]
    ax.bar([str(p) for p in prns], acq_result.peak_metric, color=colors)
    ax.axhline(0, color="k", lw=0.5)
    ax.set_xlabel("PRN")
    ax.set_ylabel("acquisition metric")
    ax.set_title("Acquisition results (green = detected)")
    fig.tight_layout()
    return fig


def plot_tracking(track_res, ch: int, cfg):
    """Per-channel tracking diagnostics (plotTracking.m): discriminators,
    prompt I/Q scatter, correlator envelopes, C/No."""
    fig, axes = plt.subplots(3, 2, figsize=(12, 9))
    ip, qp = track_res.i_p[ch], track_res.q_p[ch]
    t = np.arange(len(ip))

    axes[0, 0].scatter(ip, qp, s=2, alpha=0.4)
    axes[0, 0].set_title("Discrete-time constellation (I_P vs Q_P)")
    axes[0, 1].plot(t, ip, lw=0.5)
    axes[0, 1].set_title("Bits of the navigation message (I_P)")
    axes[1, 0].plot(t, track_res.pll_discr[ch], lw=0.5)
    axes[1, 0].set_title("Raw PLL discriminator")
    axes[1, 1].plot(t, track_res.dll_discr[ch], lw=0.5)
    axes[1, 1].set_title("Raw DLL discriminator")
    env_e = np.hypot(track_res.i_e[ch], track_res.q_e[ch])
    env_p = np.hypot(ip, qp)
    env_l = np.hypot(track_res.i_l[ch], track_res.q_l[ch])
    axes[2, 0].plot(t, env_e, lw=0.5, label="E")
    axes[2, 0].plot(t, env_p, lw=0.5, label="P")
    axes[2, 0].plot(t, env_l, lw=0.5, label="L")
    axes[2, 0].legend()
    axes[2, 0].set_title("Correlation envelopes")
    cno = track_res.cno.get(ch, np.asarray([]))
    axes[2, 1].plot(np.arange(len(cno)) * cfg.cno.vsm_interval_ms / 1e3,
                    cno, marker="o", ms=3)
    axes[2, 1].set_title("C/No (VSM) [dB-Hz]")
    fig.suptitle(f"Channel {ch}  PRN {track_res.prns[ch]}")
    fig.tight_layout()
    return fig


def plot_navigation(nav, true_enu=None):
    """E/N/U scatter + coordinate time series (plotNavigation.m)."""
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    E = np.asarray(nav.E)
    N = np.asarray(nav.N)
    U = np.asarray(nav.U)
    refE, refN, refU = (np.mean(E), np.mean(N), np.mean(U)) \
        if true_enu is None else true_enu
    axes[0].scatter(E - refE, N - refN, s=6, alpha=0.6)
    axes[0].axhline(0, color="k", lw=0.5)
    axes[0].axvline(0, color="k", lw=0.5)
    axes[0].set_xlabel("East error [m]")
    axes[0].set_ylabel("North error [m]")
    axes[0].set_title("Horizontal scatter vs reference")
    axes[0].set_aspect("equal")
    t = np.arange(len(E))
    axes[1].plot(t, E - refE, label="E")
    axes[1].plot(t, N - refN, label="N")
    axes[1].plot(t, U - refU, label="U")
    axes[1].legend()
    axes[1].set_xlabel("measurement #")
    axes[1].set_ylabel("error [m]")
    axes[1].set_title("Coordinate variations")
    fig.tight_layout()
    return fig


def sky_plot(nav, prns):
    """Polar az/el track of each satellite (skyPlot.m)."""
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="polar")
    ax.set_theta_zero_location("N")
    ax.set_theta_direction(-1)
    az = np.asarray(nav.az)       # [n_meas, n_ch]
    el = np.asarray(nav.el)
    for ch in range(az.shape[1] if az.ndim == 2 else 0):
        a = np.radians(az[:, ch])
        r = 90.0 - el[:, ch]
        m = np.isfinite(a) & np.isfinite(r)
        if m.any():
            ax.plot(a[m], r[m], ".", ms=3)
            ax.annotate(str(prns[ch]), (a[m][-1], r[m][-1]))
    ax.set_rlim(0, 90)
    ax.set_yticks([0, 30, 60, 90])
    ax.set_yticklabels(["90", "60", "30", "0"])
    ax.set_title("Sky plot (elevation rings)")
    return fig


def show_channel_status(channels, acq_result, cfg) -> str:
    """ASCII channel table (showChannelStatus.m:37-43)."""
    lines = ["*=========*=====*===============*===========*=============*",
             "| Channel | PRN |   Frequency   |  Doppler  | Code Offset |",
             "*=========*=====*===============*===========*=============*"]
    for k, (prn, freq, phase, *_) in enumerate(channels):
        doppler = freq - cfg.if_freq
        lines.append(f"|    {k + 1:2d}   | {prn:3d} | {freq:13.5g} | "
                     f"{doppler:9.0f} | {int(phase):11d} |")
    lines.append(lines[0])
    return "\n".join(lines)
