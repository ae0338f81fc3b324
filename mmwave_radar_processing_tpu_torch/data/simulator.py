"""Synthetic FMCW point-target scene simulator.

Generates raw TI-style ADC cubes ``[rx, sample, chirp]`` (TDM-MIMO chirp
interleaving included) from point targets with known range / angle / radial
velocity, so the whole pipeline is testable and benchmarkable without the
reference's non-distributable sample recordings.

Signal model per target, sample ``n``, chirp ``m``, RX ``k`` (TX from the TDM
slot ``m % cfgs_per_loop``):

    beat frequency  f_b  = 2 * slope * r / c
    Doppler phase   4*pi * v_r * t_m / lambda,            t_m = m * Tc
    array phase     pi * (Y * cos(el) * sin(az) + Z * sin(el))

with element offsets ``Y``/``Z`` in half-wavelength units from the virtual
array geometry (TX + RX position sums) — the same lambda/2 convention the
processing stack assumes (``arcsin(delta_phi/pi)`` angle bins).

The geometry tables mirror the IWR1843 ("standard": 8-element azimuth line)
and IWR6843 ODS ("ods": 2x2 RX + triangular TX) virtual arrays such that the
reference's hardcoded antenna subsets behave as intended: azimuth sets
``[0,3,4,7]``/``[1,2,5,6]`` see a uniform lambda/2 ladder in y at constant z,
elevation sets ``[9,8,5,4]``/``[10,11,6,7]`` a ladder in z
(``velocity_estimator.py:182-259``, ``processor_params.yaml`` antenna tables).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from mmwave_radar_processing_tpu_torch.config import RadarConfig

C = 299_792_458.0


@dataclass(frozen=True)
class ArrayGeometry:
    """Virtual array element offsets in half-wavelength units."""

    rx_y: np.ndarray
    rx_z: np.ndarray
    tx_y: np.ndarray
    tx_z: np.ndarray

    def virtual_offsets(self, num_rx: int, active_tx: Sequence[int]):
        """(Y, Z) per virtual channel ``v = tx_slot * num_rx + rx``."""
        ys, zs = [], []
        for t in active_tx:
            for k in range(num_rx):
                ys.append(self.tx_y[t] + self.rx_y[k])
                zs.append(self.tx_z[t] + self.rx_z[k])
        return np.asarray(ys, float), np.asarray(zs, float)


def standard_geometry() -> ArrayGeometry:
    """IWR1843-style azimuth line: 4 RX at lambda/2, TX at 0 / 2*lambda."""
    return ArrayGeometry(
        rx_y=np.array([0.0, 1.0, 2.0, 3.0]),
        rx_z=np.zeros(4),
        tx_y=np.array([0.0, 2.0, 4.0]),
        tx_z=np.zeros(3),
    )


def ods_geometry() -> ArrayGeometry:
    """IWR6843 ODS-style 2D array (see module docstring for the constraints)."""
    return ArrayGeometry(
        rx_y=np.array([0.0, 0.0, 1.0, 1.0]),
        rx_z=np.array([1.0, 0.0, 0.0, 1.0]),
        tx_y=np.array([0.0, 2.0, 0.0]),
        tx_z=np.array([2.0, 2.0, 0.0]),
    )


GEOMETRIES = {"standard": standard_geometry, "ods": ods_geometry}


@dataclass
class PointTarget:
    """One point scatterer in the radar (FLU) frame."""

    range_m: float
    azimuth_rad: float = 0.0
    elevation_rad: float = 0.0
    velocity_m_s: float = 0.0  # radial velocity (positive = receding)
    rcs: float = 1.0
    phase_rad: float = 0.0


@dataclass
class Scene:
    """A set of targets + noise level for one simulated frame."""

    targets: List[PointTarget] = field(default_factory=list)
    noise_sigma: float = 0.05


def simulate_frame(
    cfg: RadarConfig,
    scene: Scene,
    rng: np.random.Generator | None = None,
    geometry: ArrayGeometry | None = None,
) -> np.ndarray:
    """Simulate one raw ADC frame ``[num_rx, adc_samples, chirps_per_frame]``."""
    rng = rng or np.random.default_rng(0)
    geometry = geometry or GEOMETRIES.get(cfg.array_geometry, standard_geometry)()
    p = cfg.profile(0)
    num_rx = cfg.num_rx_antennas
    ns = p.adc_samples
    cpl = cfg.chirp_cfgs_per_loop
    nm = cfg.chirps_per_frame
    fs = p.sample_rate_ksps * 1e3
    slope = p.freq_slope_mhz_us * 1e12
    lam = p.lambda_m
    tc = p.chirp_period_us * 1e-6

    # active TX slot for each chirp in the frame (frameCfg interleaving)
    tx_slots = np.arange(cfg.frame.start_index, cfg.frame.end_index + 1)

    n = np.arange(ns)
    m = np.arange(nm)
    t_m = m * tc

    cube = np.zeros((num_rx, ns, nm), dtype=np.complex64)
    for tgt in scene.targets:
        f_beat = 2.0 * slope * tgt.range_m / C
        # fast-time + slow-time phase, [ns, nm]
        phase_t = (
            2 * np.pi * f_beat * (n[:, None] / fs)
            + 4 * np.pi * tgt.velocity_m_s * t_m[None, :] / lam
            + 4 * np.pi * tgt.range_m / lam
            + tgt.phase_rad
        )
        uy = np.cos(tgt.elevation_rad) * np.sin(tgt.azimuth_rad)
        uz = np.sin(tgt.elevation_rad)
        for slot, tx in enumerate(tx_slots):
            chirp_sel = slice(slot, nm, cpl)
            y = geometry.tx_y[tx] + geometry.rx_y[:num_rx]
            z = geometry.tx_z[tx] + geometry.rx_z[:num_rx]
            # negative-going phase across the ladder so that the processing
            # chain's zero-padded FFT + fftshift + arcsin(delta_phi/pi) mapping
            # recovers +azimuth for +y targets (self-consistency validated in
            # tests/test_pipeline.py)
            phase_a = -np.pi * (y * uy + z * uz)  # [rx]
            cube[:, :, chirp_sel] += (
                tgt.rcs
                * np.exp(1j * (phase_t[None, :, chirp_sel] + phase_a[:, None, None]))
            ).astype(np.complex64)

    if scene.noise_sigma > 0:
        cube += scene.noise_sigma * (
            rng.standard_normal(cube.shape) + 1j * rng.standard_normal(cube.shape)
        ).astype(np.complex64)
    return cube


def simulate_frames(
    cfg: RadarConfig,
    scenes: Sequence[Scene],
    rng: np.random.Generator | None = None,
    geometry: ArrayGeometry | None = None,
) -> np.ndarray:
    """Stack of frames ``[frames, rx, samples, chirps]``."""
    rng = rng or np.random.default_rng(0)
    return np.stack([simulate_frame(cfg, s, rng, geometry) for s in scenes])


def ground_scene(
    cfg: RadarConfig,
    altitude_m: float,
    ego_vel: Sequence[float] = (0.0, 0.0, 0.0),
    num_patches: int = 48,
    rng: np.random.Generator | None = None,
    noise_sigma: float = 0.05,
    max_cone_deg: float = 55.0,
    nadir_rcs: float = 6.0,
) -> Scene:
    """Down-facing UAV view: ground patches on a cone below the sensor.

    Each patch at (az, el-from-boresight) has radial velocity
    ``-u . v_ego`` — the geometry the ego-velocity estimators invert.
    The radar x-axis points down (array_direction="down" convention).

    Real ground returns a strong specular nadir echo at exactly the altitude —
    that is what the altimeter's prominence-gated peak tracking locks onto —
    so a bright boresight target of RCS ``nadir_rcs`` is included (set 0 to
    disable).
    """
    rng = rng or np.random.default_rng(0)
    targets = []
    vx, vy, vz = ego_vel
    if nadir_rcs > 0:
        targets.append(
            PointTarget(
                range_m=float(altitude_m),
                velocity_m_s=-float(vx),  # boresight recession
                rcs=float(nadir_rcs),
                phase_rad=float(rng.uniform(0, 2 * np.pi)),
            )
        )
    for _ in range(num_patches):
        cone = np.deg2rad(rng.uniform(0.0, max_cone_deg))
        roll = rng.uniform(0, 2 * np.pi)
        az = np.arctan2(np.sin(cone) * np.cos(roll), np.cos(cone))
        el = np.arcsin(np.sin(cone) * np.sin(roll))
        r = altitude_m / max(np.cos(cone), 0.2)
        if r >= cfg.range_max_m * 0.95:
            continue
        u = np.array(
            [
                np.cos(el) * np.cos(az),
                np.cos(el) * np.sin(az),
                np.sin(el),
            ]
        )
        v_rad = float(u @ np.array([vx, vy, vz]))
        targets.append(
            PointTarget(
                range_m=float(r),
                azimuth_rad=float(az),
                elevation_rad=float(el),
                velocity_m_s=-v_rad,
                rcs=float(rng.uniform(0.5, 1.5)),
                phase_rad=float(rng.uniform(0, 2 * np.pi)),
            )
        )
    return Scene(targets=targets, noise_sigma=noise_sigma)
