"""A deployment's radar parameters, worked out from its TI ``.cfg`` lines.

Plain Python, independent of the program under test: the same formulas as
the upstream ``cfgManager.py`` (range and velocity resolution and extent),
the virtual-array layout of the IWR6843 ODS board and the bin grids the
processing uses.  The scene generator and the plain reference both read
their geometry from here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

SPEED_OF_LIGHT_M_S = 299_792_458.0

#: IWR6843 ODS element offsets in half wavelengths (rx, then tx), as the
#: upstream simulator and antenna tables lay the board out
ODS_RX_Y, ODS_RX_Z = (0.0, 0.0, 1.0, 1.0), (1.0, 0.0, 0.0, 1.0)
ODS_TX_Y, ODS_TX_Z = (0.0, 2.0, 0.0), (2.0, 2.0, 0.0)


@dataclass(frozen=True)
class Radar:
    """Everything the generator and the reference need to know of one deployment."""

    num_rx: int
    ns: int  # ADC samples a chirp
    loops: int  # chirp loops a frame (Doppler bins)
    cpl: int  # chirp configurations a loop (TDM transmitters)
    tx_slots: Tuple[int, ...]  # the transmitter of each chirp slot of a loop
    fs_hz: float
    slope_hz_s: float
    lambda_m: float
    chirp_period_s: float
    range_res: float
    range_max: float
    vel_res: float
    vel_max: float

    @property
    def chirps(self) -> int:
        return self.loops * self.cpl

    @property
    def n_virtual(self) -> int:
        return self.num_rx * self.cpl

    def frame_shape(self) -> Tuple[int, int, int]:
        """``(rx, samples, chirps)`` of one raw ADC frame."""
        return self.num_rx, self.ns, self.chirps

    def range_bins(self) -> np.ndarray:
        """float64 range bin centres, the ``+1e-3`` stop of the upstream processors."""
        return np.arange(0.0, self.range_max - self.range_res / 2 + 1e-3, self.range_res)

    def vel_bins(self) -> np.ndarray:
        """float64 velocity bin centres of an fftshifted Doppler transform."""
        return np.arange(-self.vel_max, self.vel_max - self.vel_res + 1e-3, self.vel_res)


def parse_cfg(lines: Sequence[str]) -> Radar:
    """The radar of a ``.cfg`` file's lines (``%`` lines are comments)."""
    fields = {}
    for line in lines:
        if "%" in line or not line.split():
            continue
        tokens = line.split()
        fields.setdefault(tokens[0], tokens[1:])
    profile, frame, channel = fields["profileCfg"], fields["frameCfg"], fields["channelCfg"]
    start_freq_hz = float(profile[1]) * 1e9
    idle_us, ramp_end_us = float(profile[2]), float(profile[4])
    slope = float(profile[7]) * 1e12
    ns, fs = int(profile[9]), float(profile[10]) * 1e3
    first, last, loops = int(frame[0]), int(frame[1]), int(frame[2])
    cpl = last - first + 1
    lam = SPEED_OF_LIGHT_M_S / start_freq_hz
    tc = (idle_us + ramp_end_us) * 1e-6
    return Radar(
        num_rx=bin(int(channel[0])).count("1"), ns=ns, loops=loops, cpl=cpl,
        tx_slots=tuple(range(first, last + 1)), fs_hz=fs, slope_hz_s=slope,
        lambda_m=lam, chirp_period_s=tc,
        range_res=SPEED_OF_LIGHT_M_S * fs / (2.0 * slope * ns),
        range_max=SPEED_OF_LIGHT_M_S * fs / (2.0 * slope),
        vel_res=lam / (2.0 * tc * cpl * loops),
        vel_max=lam / (4.0 * tc * cpl),
    )


def angle_bins(n: int) -> np.ndarray:
    """float64 ``arcsin(phase / pi)`` over ``n`` phase shifts from ``pi`` down to ``-pi``."""
    step = 2 * math.pi / (n - 1)
    phase = np.arange(math.pi, -math.pi - step, -step)[:n]
    phase[-1] = -math.pi
    return np.arcsin(phase / math.pi)


def valid_angle_bins(velocity: dict) -> int:
    """Angle bins of the velocity path's DFT that lie within its valid angle range."""
    bins = angle_bins(velocity["num_angle_bins"])
    lo, hi = np.deg2rad(velocity["valid_angle_deg"])
    return int(((bins >= lo) & (bins <= hi)).sum())
