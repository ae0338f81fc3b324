"""TI mmWave-SDK ``.cfg`` parsing and derived radar performance parameters.

This is a clean-room, dataclass-based re-design of the reference's mutable
``ConfigManager`` attribute bag (``config_managers/cfgManager.py:16-363``).
The same CLI commands are understood (``channelCfg``, ``adcCfg``,
``adcbufCfg``, ``profileCfg``, ``chirpCfg``, ``frameCfg``) and the same
performance formulas are applied (``cfgManager.py:113-158``), but the result is
an immutable :class:`RadarConfig` whose derived quantities are computed once at
load time.  The port's copy of the JAX package's ``config/manager.py``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional

SPEED_OF_LIGHT_M_S = 299_792_458.0


class ConfigNotLoaded(Exception):
    """Exported for reference import parity (ref cfgManager.py:13).

    Like the reference's, this exception is defined but never raised:
    pre-load access raises :class:`InvalidConfiguration` (or AttributeError
    for unknown attributes)."""


class InvalidConfiguration(Exception):
    """Raised when a ``.cfg`` file cannot be interpreted."""


@dataclass(frozen=True)
class ProfileCfg:
    """One ``profileCfg`` line (chirp profile).

    Field meanings follow the TI mmWave-SDK CLI; units are embedded in names.
    """

    profile_id: int = 0
    start_freq_ghz: float = 77.0
    idle_time_us: float = 0.0
    adc_start_time_us: float = 0.0
    ramp_end_time_us: float = 0.0
    tx_out_power: float = 0.0
    tx_phase_shifter: float = 0.0
    freq_slope_mhz_us: float = 0.0
    tx_start_time_us: float = 0.0
    adc_samples: int = 0
    sample_rate_ksps: int = 0
    hpf_corner_freq1: float = 0.0
    hpf_corner_freq2: float = 0.0
    rx_gain_db: float = 0.0

    @property
    def chirp_period_us(self) -> float:
        """Idle + ramp time: period of one chirp within a loop."""
        return self.idle_time_us + self.ramp_end_time_us

    @property
    def lambda_m(self) -> float:
        """Wavelength at the chirp start frequency."""
        return SPEED_OF_LIGHT_M_S / (self.start_freq_ghz * 1e9)


@dataclass(frozen=True)
class ChirpCfg:
    """One ``chirpCfg`` line (per-chirp variation + TX mask)."""

    start_index: int = 0
    end_index: int = 0
    profile: int = 0
    start_freq_variation_hz: float = 0.0
    freq_slope_variation_mhz_us: float = 0.0
    idle_time_variation_us: float = 0.0
    adc_start_time_variation_us: float = 0.0
    tx_mask: int = 0


@dataclass(frozen=True)
class FrameCfg:
    """The ``frameCfg`` line: which chirpCfgs repeat, how often."""

    start_index: int = 0
    end_index: int = 0
    loops: int = 0
    frames: int = 0
    periodicity_ms: float = 0.0
    hardware_trigger_enabled: bool = False
    trigger_delay_ms: float = 0.0

    @property
    def chirp_cfgs_per_loop(self) -> int:
        return self.end_index - self.start_index + 1


@dataclass(frozen=True)
class RadarConfig:
    """Immutable parsed radar configuration + derived performance parameters.

    Derived fields mirror the reference formulas exactly
    (``cfgManager.py:113-158``) so every downstream bin grid matches:

    - ``range_res_m   = c * fs / (2 * slope * N)``
    - ``range_bin_size_m`` uses next-pow-2 of N
    - ``range_max_m   = c * fs / (2 * slope)``
    - ``vel_res_m_s   = lambda / (2 * Tc * chirps_per_loop * loops)``
    - ``vel_max_m_s   = lambda / (4 * Tc * chirps_per_loop)``
    """

    profiles: List[ProfileCfg] = field(default_factory=list)
    chirps: List[ChirpCfg] = field(default_factory=list)
    frame: FrameCfg = field(default_factory=FrameCfg)

    # channelCfg
    rx_chan_mask: int = 0
    tx_chan_mask: int = 0
    cascading: int = 0
    num_rx_antennas: int = 4
    num_tx_antennas: int = 3

    # adcCfg / adcbufCfg
    num_adc_bits: int = 16
    adc_output_fmt: int = 0
    adcbuf_output_fmt: int = 0
    adcbuf_sample_swap: bool = False
    adcbuf_channel_interleave: bool = False
    adcbuf_chirp_threshold: int = 1

    # array metadata (caller-provided, reference-compatible strings)
    array_geometry: str = "standard"  # "standard" | "ods"
    array_direction: str = "down"  # "down" | "out"

    # derived (filled by ``derive()``)
    range_res_m: float = 0.0
    range_bin_size_m: float = 0.0
    range_max_m: float = 0.0
    vel_res_m_s: float = 0.0
    vel_max_m_s: float = 0.0
    virtual_antennas_enabled: bool = False

    # ------------------------------------------------------------------ #
    # convenience accessors
    # ------------------------------------------------------------------ #
    def profile(self, idx: int = 0) -> ProfileCfg:
        return self.profiles[idx]

    @property
    def num_adc_samples(self) -> int:
        return self.profile(0).adc_samples

    @property
    def sample_rate_ksps(self) -> int:
        return self.profile(0).sample_rate_ksps

    @property
    def chirp_slope_mhz_us(self) -> float:
        return self.profile(0).freq_slope_mhz_us

    @property
    def lambda_m(self) -> float:
        return self.profile(0).lambda_m

    @property
    def chirp_period_us(self) -> float:
        return self.profile(0).chirp_period_us

    @property
    def chirp_cfgs_per_loop(self) -> int:
        return self.frame.chirp_cfgs_per_loop

    @property
    def chirps_per_frame(self) -> int:
        return self.frame.chirp_cfgs_per_loop * self.frame.loops

    @property
    def num_virtual_antennas(self) -> int:
        """RX count after TDM-MIMO virtual-array reformatting."""
        return self.num_rx_antennas * self.frame.chirp_cfgs_per_loop

    @property
    def frame_period_s(self) -> float:
        return self.frame.periodicity_ms * 1e-3

    # ------------------------------------------------------------------ #
    # derived performance parameters
    # ------------------------------------------------------------------ #
    def derive(self, profile_idx: int = 0) -> "RadarConfig":
        """Return a copy with derived performance parameters filled in.

        Formula parity with the reference: ``cfgManager.py:113-158`` —
        including the chirps-per-loop convention where the Doppler sampling
        interval is ``chirp_period * chirp_cfgs_per_loop`` (TDM MIMO).
        """
        p = self.profiles[profile_idx]
        fs_hz = p.sample_rate_ksps * 1e3
        slope_hz_s = p.freq_slope_mhz_us * 1e12  # MHz/us -> Hz/s
        n = p.adc_samples
        if n <= 0 or slope_hz_s <= 0:
            raise InvalidConfiguration("profileCfg missing adcSamples/slope")

        num_range_bins = 2 ** math.ceil(math.log2(n))
        range_res = SPEED_OF_LIGHT_M_S * fs_hz / (2.0 * slope_hz_s * n)
        range_bin_size = SPEED_OF_LIGHT_M_S * fs_hz / (2.0 * slope_hz_s * num_range_bins)
        range_max = SPEED_OF_LIGHT_M_S * fs_hz / (2.0 * slope_hz_s)

        lam = p.lambda_m
        cpl = self.frame.chirp_cfgs_per_loop
        loops = float(self.frame.loops)
        tc_s = p.chirp_period_us * 1e-6
        vel_res = lam / (2.0 * tc_s * cpl * loops)
        vel_max = lam / (4.0 * tc_s * cpl)

        return dataclasses.replace(
            self,
            range_res_m=range_res,
            range_bin_size_m=range_bin_size,
            range_max_m=range_max,
            vel_res_m_s=vel_res,
            vel_max_m_s=vel_max,
            virtual_antennas_enabled=cpl > 1,
        )

    def overview(self) -> str:
        """Human-readable configuration overview (reference: cfgManager.py:187-204)."""
        p = self.profile(0)
        active_ms = self.chirps_per_frame * p.chirp_period_us * 1e-3
        return (
            "---- Radar Configuration Overview ----\n"
            f"range res: {self.range_res_m:.4f} m | range max: {self.range_max_m:.4f} m\n"
            f"vel res: {self.vel_res_m_s:.4f} m/s | vel max: {self.vel_max_m_s:.4f} m/s\n"
            f"rx: {self.num_rx_antennas} tx: {self.num_tx_antennas} "
            f"virtual: {self.num_virtual_antennas} ({self.array_geometry}/{self.array_direction})\n"
            f"chirp period: {p.chirp_period_us} us | loops: {self.frame.loops} | "
            f"active frame: {active_ms:.2f} ms | frame period: {self.frame.periodicity_ms} ms\n"
            f"start freq: {p.start_freq_ghz} GHz"
        )


# ---------------------------------------------------------------------- #
# parsing
# ---------------------------------------------------------------------- #
_ADC_BITS = {0: 12, 1: 14, 2: 16}


def _parse_line(tokens: List[str], state: dict) -> None:
    key = tokens[0]
    if key == "channelCfg":
        state["rx_chan_mask"] = int(tokens[1])
        state["tx_chan_mask"] = int(tokens[2])
        state["cascading"] = int(tokens[3])
        state["num_rx_antennas"] = bin(int(tokens[1])).count("1")
        state["num_tx_antennas"] = bin(int(tokens[2])).count("1")
    elif key == "adcCfg":
        state["num_adc_bits"] = _ADC_BITS.get(int(tokens[1]), 16)
        state["adc_output_fmt"] = int(tokens[2])
    elif key == "adcbufCfg":
        state["adcbuf_output_fmt"] = int(tokens[-4])
        state["adcbuf_sample_swap"] = int(tokens[-3]) != 0
        state["adcbuf_channel_interleave"] = int(tokens[-2]) == 0
        state["adcbuf_chirp_threshold"] = int(tokens[-1])
    elif key == "profileCfg":
        state["profiles"].append(
            ProfileCfg(
                profile_id=int(tokens[1]),
                start_freq_ghz=float(tokens[2]),
                idle_time_us=float(tokens[3]),
                adc_start_time_us=float(tokens[4]),
                ramp_end_time_us=float(tokens[5]),
                tx_out_power=float(tokens[6]),
                tx_phase_shifter=float(tokens[7]),
                freq_slope_mhz_us=float(tokens[8]),
                tx_start_time_us=float(tokens[9]),
                adc_samples=int(tokens[10]),
                sample_rate_ksps=int(tokens[11]),
                hpf_corner_freq1=float(tokens[12]),
                hpf_corner_freq2=float(tokens[13]),
                rx_gain_db=float(tokens[14]),
            )
        )
    elif key == "chirpCfg":
        state["chirps"].append(
            ChirpCfg(
                start_index=int(tokens[1]),
                end_index=int(tokens[2]),
                profile=int(tokens[3]),
                start_freq_variation_hz=float(tokens[4]),
                freq_slope_variation_mhz_us=float(tokens[5]),
                idle_time_variation_us=float(tokens[6]),
                adc_start_time_variation_us=float(tokens[7]),
                tx_mask=int(tokens[8]),
            )
        )
    elif key == "frameCfg":
        state["frame"] = FrameCfg(
            start_index=int(tokens[1]),
            end_index=int(tokens[2]),
            loops=int(tokens[3]),
            frames=int(tokens[4]),
            periodicity_ms=float(tokens[5]),
            # reference convention (cfgManager.py:359): param==1 -> software
            # trigger (False); anything else -> hardware trigger (True)
            hardware_trigger_enabled=int(tokens[6]) != 1,
            trigger_delay_ms=float(tokens[7]),
        )


def load_cfg(
    cfg_file_path: str,
    array_geometry: str = "standard",
    array_direction: str = "down",
) -> RadarConfig:
    """Parse a TI ``.cfg`` file and return a fully-derived :class:`RadarConfig`.

    Lines containing ``%`` are comments (reference convention,
    ``cfgManager.py:234``); unknown commands are ignored.

    Args:
        cfg_file_path: path to the ``.cfg`` file.
        array_geometry: ``"standard"`` or ``"ods"``.
        array_direction: ``"down"`` or ``"out"``.
    """
    state: dict = {"profiles": [], "chirps": [], "frame": FrameCfg()}
    with open(cfg_file_path, "r") as f:
        for line in f:
            if "%" in line:
                continue
            tokens = line.strip().split()
            if not tokens:
                continue
            try:
                _parse_line(tokens, state)
            except (IndexError, ValueError) as e:
                raise InvalidConfiguration(
                    f"malformed {tokens[0]} line in {cfg_file_path}: {line.strip()!r}"
                ) from e

    if not state["profiles"]:
        raise InvalidConfiguration(f"no profileCfg found in {cfg_file_path}")

    cfg = RadarConfig(
        profiles=state["profiles"],
        chirps=state["chirps"],
        frame=state["frame"],
        rx_chan_mask=state.get("rx_chan_mask", 0),
        tx_chan_mask=state.get("tx_chan_mask", 0),
        cascading=state.get("cascading", 0),
        num_rx_antennas=state.get("num_rx_antennas", 4),
        num_tx_antennas=state.get("num_tx_antennas", 3),
        num_adc_bits=state.get("num_adc_bits", 16),
        adc_output_fmt=state.get("adc_output_fmt", 0),
        adcbuf_output_fmt=state.get("adcbuf_output_fmt", 0),
        adcbuf_sample_swap=state.get("adcbuf_sample_swap", False),
        adcbuf_channel_interleave=state.get("adcbuf_channel_interleave", False),
        adcbuf_chirp_threshold=state.get("adcbuf_chirp_threshold", 1),
        array_geometry=array_geometry,
        array_direction=array_direction,
    )
    return cfg.derive(profile_idx=0)


class ConfigManager:
    """Mutable reference-API-compatible facade over :class:`RadarConfig`.

    Users migrating from the reference library can keep calling
    ``ConfigManager().load_cfg(path)`` / ``compute_radar_perforance()`` [sic —
    the typo'd name is part of the reference's de-facto API, used by its
    scripts and tests, e.g. ``tests/verify_processors.py:22``] and reading the
    same attribute names (``range_res_m``, ``vel_max_m_s``,
    ``frameCfg_loops``...).  Internally everything is an immutable
    :class:`RadarConfig` exposed as ``.config``.
    """

    def __init__(self) -> None:
        self.config: Optional[RadarConfig] = None
        self.config_loaded = False

    def load_cfg(
        self,
        cfg_file_path: str,
        array_geometry: str = "standard",
        array_direction: str = "down",
    ) -> RadarConfig:
        self.config = load_cfg(cfg_file_path, array_geometry, array_direction)
        self.config_loaded = True
        return self.config

    def compute_radar_perforance(self, profile_idx: int = 0) -> None:  # noqa: D401 (sic)
        """Recompute derived parameters (reference-compatible name, sic)."""
        self._require_loaded()
        self.config = self.config.derive(profile_idx=profile_idx)

    compute_radar_performance = compute_radar_perforance

    def _require_loaded(self) -> None:
        if self.config is None:
            raise InvalidConfiguration("no configuration loaded")

    # reference-style attribute access ---------------------------------- #
    _ATTR_MAP = {
        "range_res_m": "range_res_m",
        "range_bin_size_m": "range_bin_size_m",
        "range_max_m": "range_max_m",
        "vel_res_m_s": "vel_res_m_s",
        "vel_max_m_s": "vel_max_m_s",
        "num_rx_antennas": "num_rx_antennas",
        "num_tx_antennas": "num_tx_antennas",
        "virtual_antennas_enabled": "virtual_antennas_enabled",
        "array_geometry": "array_geometry",
        "array_direction": "array_direction",
    }

    def __getattr__(self, name: str):
        cfg = object.__getattribute__(self, "__dict__").get("config")
        if cfg is not None:
            if name in ConfigManager._ATTR_MAP:
                return getattr(cfg, ConfigManager._ATTR_MAP[name])
            if name == "frameCfg_start_index":
                return cfg.frame.start_index
            if name == "frameCfg_end_index":
                return cfg.frame.end_index
            if name == "frameCfg_loops":
                return cfg.frame.loops
            if name == "frameCfg_periodicity_ms":
                return cfg.frame.periodicity_ms
            if name == "profile_cfgs":
                return [
                    {
                        "profileId": p.profile_id,
                        "startFreq_GHz": p.start_freq_ghz,
                        "idleTime_us": p.idle_time_us,
                        "adcStartTime_us": p.adc_start_time_us,
                        "rampEndTime_us": p.ramp_end_time_us,
                        "txOutPower": p.tx_out_power,
                        "txPhaseShifter": p.tx_phase_shifter,
                        "freqSlope_MHz_us": p.freq_slope_mhz_us,
                        "txStartTime_us": p.tx_start_time_us,
                        "adcSamples": p.adc_samples,
                        "sampleRate_kSps": p.sample_rate_ksps,
                        "hpfCornerFreq1": p.hpf_corner_freq1,
                        "hpfCornerFreq2": p.hpf_corner_freq2,
                        "rxGain_dB": p.rx_gain_db,
                    }
                    for p in cfg.profiles
                ]
        raise AttributeError(name)

    def get_num_adc_samples(self, profile_idx: int = 0) -> int:
        self._require_loaded()
        return self.config.profiles[profile_idx].adc_samples

    def get_adc_sample_rate_kSps(self, profile_idx: int = 0) -> int:
        self._require_loaded()
        return self.config.profiles[profile_idx].sample_rate_ksps

    def get_chirp_slope_MHz_us(self, profile_idx: int = 0) -> float:
        self._require_loaded()
        return self.config.profiles[profile_idx].freq_slope_mhz_us

    def print_cfg_overview(self) -> None:
        self._require_loaded()
        print(self.config.overview())
