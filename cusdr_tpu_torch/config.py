"""Typed receiver configuration with per-signal presets.

This replaces the reference's per-receiver flat ``settings`` structs
(e.g. GPS/GPS_L1CA/initSettings.m, GPS/GPS_L2C/initSettings.m, ...) with a
single frozen dataclass; the 12 signal presets mirror the exact fields and
defaults of each ``initSettings.m`` so a user of the reference finds the same
knobs here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CNoConfig:
    """C/No estimator settings (initSettings.m:132-136)."""
    acc_time_s: float = 0.001       # accumulation interval in tracking [s]
    vsm_interval_ms: int = 40       # VSM accumulation interval [ms]


@dataclass(frozen=True)
class TruePosition:
    """Surveyed antenna position in UTM, NaN => use mean fix
    (initSettings.m:119-121)."""
    E: float = float("nan")
    N: float = float("nan")
    U: float = float("nan")


@dataclass(frozen=True)
class ReceiverConfig:
    """All knobs for one signal's receiver chain.

    Field-by-field mirror of the reference ``initSettings.m`` structs, plus
    TPU-build extras (superblock sizing, dtypes).
    """

    # --- identity -----------------------------------------------------------
    signal: str = "gps_l1ca"            # key into the signal registry

    # --- processing (initSettings.m:44-53) ----------------------------------
    ms_to_process: int = 60_000
    num_channels: int = 12
    skip_number_of_bytes: int = 0

    # --- raw file (initSettings.m:58-73) -------------------------------------
    file_name: str = ""
    data_type: str = "schar"            # 'schar' | 'int16'
    file_type: int = 2                  # 1 = real, 2 = interleaved I/Q
    packed_iq: bool = False             # 2-bit packed sign/mag (unpack_cplx.m)
    if_freq: float = 20e3               # intermediate frequency [Hz]
    sampling_freq: float = 18e6         # [Hz]
    code_freq_basis: float = 1.023e6    # chipping rate [Hz]
    code_length: int = 1023             # chips per primary-code period

    # --- acquisition (initSettings.m:77-93) ----------------------------------
    skip_acquisition: bool = False
    acq_satellite_list: Tuple[int, ...] = tuple(range(1, 33))
    acq_search_band: float = 7000.0     # single-sided Doppler search band [Hz]
    acq_non_coh_time: int = 20          # non-coherent rounds [code periods]
    acq_coh_time: int = 1               # coherent integration [ms]; spans
                                        # of > one code period tile the code
                                        # replica (no secondary/bit wipe-off
                                        # in the coarse stage)
    acq_threshold: float = 3.5
    acq_search_step: float = 500.0      # coarse Doppler step [Hz]
    resampling_threshold: float = 8e6
    resampling_flag: bool = False
    acq_metric: str = "glrt"            # 'glrt' | 'second_peak'
                                        # (L2C/B1I use peak ratios)
    fine_search_step: float = 25.0      # fine Doppler step [Hz] (acquisition.m:138)
    fine_n_codes: int = 0               # fine-stage coherent code periods
                                        # (0 = auto ~40 ms; E5a: 100 -> 100 ms
                                        # fully coherent, GAL_E5a/include/
                                        # acquisition.m:145-157)
    acq_method: str = "pcps"            # 'pcps' = per-bin carrier mixing;
                                        # 'circshift' = one signal FFT, Doppler
                                        # via spectrum bin rotation + sub-bin
                                        # mixes (GPS_L2C/include/
                                        # acquisition.m:25,71-84)

    # --- tracking loops (initSettings.m:96-105) -------------------------------
    dll_damping_ratio: float = 0.7
    dll_noise_bandwidth: float = 1.5    # [Hz]
    dll_correlator_spacing: float = 0.5  # [chips]
    pll_damping_ratio: float = 0.7
    pll_noise_bandwidth: float = 20.0   # [Hz]
    int_time: float = 0.001             # DLL/PLL integration time [s]
    pll_order: int = 2                  # 2 = calcLoopCoef, 3 = calcLoopCoefCarr
    pilot_trk_flag: int = 0             # 0=data only, 1=data+pilot (B1C: 1=NB, 2=WB)
    loop_design: str = "reference"      # 'reference' = calcLoopCoef.m discrete
                                        # update (unstable for BL*T >~ 0.17);
                                        # 'exact' = pole-placement digital design
                                        # (loop_filters.calc_loop_coef_exact),
                                        # stable at any BL*T, identical as T->0
    lock_detect: bool = True            # drop channels on PLL loss of lock
                                        # (on by default — the reference's
                                        # channel lifecycle / out-of-data
                                        # exit is unconditional,
                                        # tracking.m:241-245)
    lock_threshold: float = 0.3         # NBD/NBP gate (Calc_CNo_PLD.m:65-73)
    lock_power_drop_db: float = 10.0    # prompt-power drop vs the channel's
                                        # own first-superblock baseline that
                                        # also trips the gate (the
                                        # rectified-I NBD/NBP detector
                                        # saturates near 1 on pure noise, so
                                        # a blackout only shows in power)
    carrier_lock_test: str = "nbd_nbp"  # the lock gate's carrier test:
                                        # 'nbd_nbp' = pll_lock_detector
                                        # against lock_threshold, the
                                        # reference's; 'in_phase_share' =
                                        # |I_P| > |Q_P| in 80 % of the
                                        # epochs (blind to sign flips,
                                        # tracking/engine.py)

    # --- navigation solution (initSettings.m:106-121) -------------------------
    nav_sol_period_ms: int = 500
    elevation_mask_deg: float = 5.0
    use_trop_corr: bool = True
    true_position: TruePosition = field(default_factory=TruePosition)

    # --- constants (initSettings.m:128-130) -----------------------------------
    start_offset_ms: float = 68.802     # initial signal travel time [ms]

    # --- C/No (initSettings.m:132-136) ----------------------------------------
    cno: CNoConfig = field(default_factory=CNoConfig)

    # --- GLONASS FDMA (GLO/GLO_GL1/initSettings.m:73) -------------------------
    freq_spacing: float = 0.0           # FDMA channel spacing [Hz]; 0 = CDMA

    # --- B1C wideband (BDS/B1C/initSettings.m:59 FEBW) ------------------------
    front_end_bw: float = 27e6          # front-end bandwidth [Hz]

    # --- TPU-build extras -----------------------------------------------------
    superblock_ms: int = 1000           # samples staged to device per scan
    track_block_pad: int = 8            # extra samples per epoch block
    use_pallas: Optional[bool] = None   # fused Pallas correlator bank;
                                        # None = auto (on for TPU backends,
                                        # XLA fallback elsewhere)
    time_blocks: int = 0                # >1: time-parallel tracking over this
                                        # many concurrent blocks (parallel/
                                        # timeblocks.py); 0/1 = sequential
    handoff_iters: int = 1              # time-parallel state-handoff rounds
                                        # (block k's final loop state becomes
                                        # block k+1's start; 0 = predict-only)
    settle_epochs: int = 200            # epochs masked from measurement after
                                        # each block boundary when
                                        # handoff_iters == 0
    interp_taps: bool = True            # sub-sample replica interpolation in
                                        # the correlators; False = nearest-
                                        # sample taps, the reference's own
                                        # fidelity (ceil-index lookup,
                                        # tracking.m:252-270) at lower cost

    # -------------------------------------------------------------------------
    @property
    def samples_per_code(self) -> int:
        """round(fs / (code_freq / code_length)) (acquisition.m:116-117)."""
        return int(round(self.sampling_freq /
                         (self.code_freq_basis / self.code_length)))

    @property
    def samples_per_ms(self) -> float:
        return self.sampling_freq * 1e-3

    @property
    def code_period_s(self) -> float:
        return self.code_length / self.code_freq_basis

    @property
    def code_period_ms(self) -> float:
        return 1000.0 * self.code_length / self.code_freq_basis

    @property
    def num_freq_bins(self) -> int:
        """round(2*band/step) + 1 (acquisition.m:124)."""
        return int(round(self.acq_search_band * 2 / self.acq_search_step)) + 1

    @property
    def bytes_per_sample(self) -> int:
        per = 1 if self.data_type == "schar" else 2
        return per * (2 if self.file_type == 2 else 1)

    def replace(self, **kw) -> "ReceiverConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets — one per reference receiver, mirroring each initSettings.m.
# acq_search_band is normalized to single-sided Hz everywhere (the reference
# uses kHz for L2C/B1I, Hz elsewhere).
# ---------------------------------------------------------------------------

def gps_l1ca() -> ReceiverConfig:
    """GPS/GPS_L1CA/initSettings.m defaults."""
    return ReceiverConfig(signal="gps_l1ca")


def gps_l2c() -> ReceiverConfig:
    """GPS/GPS_L2C/initSettings.m: CM 10230 chips @ 0.5115 Mcps (20 ms),
    circular-shift freq search (acqCohT=20, acqStep=12.5 Hz), CL pilot."""
    return ReceiverConfig(
        signal="gps_l2c", sampling_freq=8e6, if_freq=20e3,
        code_freq_basis=0.5115e6, code_length=10_230, num_channels=12,
        acq_search_band=10_000.0, acq_threshold=1.5,
        acq_metric="second_peak", acq_method="circshift",
        acq_coh_time=20, acq_non_coh_time=1, acq_search_step=12.5,
        resampling_threshold=6e6,
        dll_noise_bandwidth=4.0, dll_correlator_spacing=0.25,
        # PLL 10 Hz x 20 ms (BL*T = 0.2): the reference's calcLoopCoef
        # discrete update is linearly UNSTABLE at its own preset
        # (tests/test_loop_design.py proves it); the pole-placement
        # design tracks at the specified bandwidth.
        pll_noise_bandwidth=10.0, int_time=0.020, pilot_trk_flag=0,
        loop_design="exact",
    )


def gps_l5c() -> ReceiverConfig:
    """GPS/GPS_L5C/initSettings.m: 10.23 Mcps, 25 ms non-coherent, NH20 pilot."""
    return ReceiverConfig(
        signal="gps_l5c", sampling_freq=18e6, if_freq=20e3,
        code_freq_basis=10.23e6, code_length=10_230, num_channels=12,
        acq_search_band=5000.0, acq_non_coh_time=25, acq_threshold=4.5,
        acq_search_step=500.0,
        dll_noise_bandwidth=2.0, dll_correlator_spacing=0.5,
        pll_noise_bandwidth=15.0, int_time=0.001, pilot_trk_flag=0,
    )


def gal_e1c() -> ReceiverConfig:
    """GAL/GAL_E1C/initSettings.m: BOC(1,1) 4092 chips / 4 ms, joint
    data+pilot acquisition, I/NAV, 200 ms nav period."""
    return ReceiverConfig(
        signal="gal_e1c", sampling_freq=18e6, if_freq=20e3,
        code_freq_basis=1.023e6, code_length=4092, num_channels=12,
        acq_satellite_list=tuple(range(1, 37)),
        acq_search_band=7000.0, acq_non_coh_time=1, acq_search_step=150.0,
        acq_threshold=10.0, resampling_threshold=50e6,
        dll_noise_bandwidth=1.5, dll_correlator_spacing=0.3,
        pll_noise_bandwidth=15.0, int_time=0.004, pilot_trk_flag=1,
        nav_sol_period_ms=200,
    )


def gal_e5a() -> ReceiverConfig:
    """GAL/GAL_E5a/initSettings.m: 10.23 Mcps, CS100 pilot secondary, F/NAV."""
    return ReceiverConfig(
        signal="gal_e5a", sampling_freq=18e6, if_freq=20e3,
        code_freq_basis=10.23e6, code_length=10_230, num_channels=12,
        acq_satellite_list=tuple(range(1, 37)),
        acq_search_band=5000.0, acq_non_coh_time=15, acq_threshold=4.5,
        acq_search_step=500.0,
        # fine stage: 100 ms fully coherent with CS100 wipe-off at 5 Hz
        # bins (GAL_E5a/include/acquisition.m:145-157,229-253)
        fine_search_step=5.0, fine_n_codes=100,
        dll_noise_bandwidth=1.5, dll_correlator_spacing=0.5,
        pll_noise_bandwidth=15.0, int_time=0.001, pilot_trk_flag=1,
        # NBD/NBP reads ~0.9 on the data arm's sign flips without carrier
        # lock, so a hand-off outside the fine window is kept
        carrier_lock_test="in_phase_share",
    )


def gal_e5b() -> ReceiverConfig:
    """GAL/GAL_E5b/initSettings.m: like E5a; 60 Hz acq step, PLL 25 Hz
    3rd order (calcLoopCoefCarr.m option)."""
    return ReceiverConfig(
        signal="gal_e5b", sampling_freq=18e6, if_freq=20e3,
        code_freq_basis=10.23e6, code_length=10_230, num_channels=12,
        acq_satellite_list=tuple(range(1, 37)),
        acq_search_band=5000.0, acq_non_coh_time=15, acq_threshold=4.5,
        acq_search_step=60.0,
        dll_noise_bandwidth=1.5, dll_correlator_spacing=0.5,
        pll_noise_bandwidth=25.0, int_time=0.001, pll_order=3,
        pilot_trk_flag=1,
    )


def glo_l1() -> ReceiverConfig:
    """GLO/GLO_GL1/initSettings.m: FDMA, 511-chip m-sequence @ 0.511 Mcps,
    frequency channels -7..6, 562.5 kHz spacing, IF 0."""
    return ReceiverConfig(
        signal="glo_l1", sampling_freq=12e6, if_freq=0.0,
        code_freq_basis=0.511e6, code_length=511, num_channels=12,
        acq_satellite_list=tuple(range(-7, 7)),
        acq_search_band=5000.0, acq_non_coh_time=20, acq_threshold=2.0,
        acq_search_step=500.0,
        dll_noise_bandwidth=2.0, dll_correlator_spacing=0.5,
        pll_noise_bandwidth=25.0, int_time=0.001,
        freq_spacing=562.5e3,
    )


def glo_l2() -> ReceiverConfig:
    """GLO/GLO_GL2/initSettings.m: L2 FDMA, 437.5 kHz spacing."""
    return glo_l1().replace(signal="glo_l2", freq_spacing=437.5e3)


def bds_b1c() -> ReceiverConfig:
    """BDS/B1C/initSettings.m: Weil codes, BOC(1,1)/QMBOC, acqCohT=10
    (acqStep=50 Hz), 3rd-order PLL, 15 channels, B-CNAV1."""
    return ReceiverConfig(
        signal="bds_b1c", sampling_freq=18e6, if_freq=20e3,
        code_freq_basis=1.023e6, code_length=10_230, num_channels=15,
        acq_satellite_list=tuple(range(1, 63)),
        acq_search_band=5000.0, acq_coh_time=10, acq_non_coh_time=1,
        acq_search_step=50.0, acq_threshold=10.0, resampling_threshold=15e6,
        dll_noise_bandwidth=1.0, dll_correlator_spacing=0.06,
        pll_noise_bandwidth=18.0, int_time=0.010, pll_order=3,
        pilot_trk_flag=1, nav_sol_period_ms=200,
    )


def bds_b1i() -> ReceiverConfig:
    """BDS/B1I/initSettings.m: 2046 chips @ 2.046 Mcps, PRNs 6-58,
    D1 NAV + NH20."""
    return ReceiverConfig(
        signal="bds_b1i", sampling_freq=18e6, if_freq=20e3,
        code_freq_basis=2.046e6, code_length=2046, num_channels=12,
        acq_satellite_list=tuple(range(6, 59)),
        acq_search_band=10_000.0, acq_threshold=2.0,
        resampling_threshold=9e6,
        dll_noise_bandwidth=4.0, dll_correlator_spacing=0.5,
        pll_noise_bandwidth=35.0, int_time=0.001,
    )


def bds_b2a() -> ReceiverConfig:
    """BDS/B2a/initSettings.m: 10.23 Mcps data/pilot, NH5, B-CNAV2."""
    return ReceiverConfig(
        signal="bds_b2a", sampling_freq=18e6, if_freq=20e3,
        code_freq_basis=10.23e6, code_length=10_230, num_channels=12,
        acq_satellite_list=tuple(list(range(19, 31)) + list(range(32, 47)) +
                                 [59, 60]),
        acq_search_band=5000.0, acq_non_coh_time=15, acq_threshold=5.0,
        acq_search_step=500.0,
        dll_noise_bandwidth=2.0, dll_correlator_spacing=0.5,
        pll_noise_bandwidth=15.0, int_time=0.001, pilot_trk_flag=0,
    )


def bds_b3i() -> ReceiverConfig:
    """BDS/B3I/initSettings.m: 10230 chips @ 10.23 Mcps, D1 NAV + NH20,
    15 channels."""
    return ReceiverConfig(
        signal="bds_b3i", sampling_freq=18e6, if_freq=20e3,
        code_freq_basis=10.23e6, code_length=10_230, num_channels=15,
        acq_satellite_list=tuple(range(1, 64)),
        acq_search_band=5000.0, acq_non_coh_time=10, acq_threshold=3.0,
        acq_search_step=500.0,
        dll_noise_bandwidth=2.0, dll_correlator_spacing=0.5,
        pll_noise_bandwidth=15.0, int_time=0.001,
    )


PRESETS = {
    "gps_l1ca": gps_l1ca,
    "gps_l2c": gps_l2c,
    "gps_l5c": gps_l5c,
    "gal_e1c": gal_e1c,
    "gal_e5a": gal_e5a,
    "gal_e5b": gal_e5b,
    "glo_l1": glo_l1,
    "glo_l2": glo_l2,
    "bds_b1c": bds_b1c,
    "bds_b1i": bds_b1i,
    "bds_b2a": bds_b2a,
    "bds_b3i": bds_b3i,
}


def get_config(signal: str, **overrides) -> ReceiverConfig:
    """Build the preset config for ``signal`` with optional field overrides."""
    cfg = PRESETS[signal]()
    return cfg.replace(**overrides) if overrides else cfg
