"""Static bin grids (range / velocity / angle) derived from a RadarConfig.

These are host-side ``numpy`` constants (the port's copy of the JAX package's
``config/grids.py``, bit-equal).  The
reference library computes the same grids independently in each processor with
slightly different epsilon conventions; those quirks are reproduced here
faithfully (each variant is documented with its reference location) because
downstream numerical parity depends on them — e.g. whether ``arange`` emits 63
or 64 bins hinges on the ``+1e-3``.
"""

from __future__ import annotations

import numpy as np

from mmwave_radar_processing_tpu_torch.config.manager import RadarConfig


def range_bins(cfg: RadarConfig, variant: str = "eps") -> np.ndarray:
    """Range bin centers in meters.

    Variants (all produce ``num_adc_samples`` bins for shipped configs):

    - ``"plain"``: ``arange(0, range_max - res/2, res)``
      (reference ``range_resp.py:26-30``).
    - ``"eps"``: same but with ``+1e-3`` added to the stop
      (``range_doppler_resp.py:44-47``, ``doppler_azimuth_resp.py:51-55``,
      ``micro_doppler_resp.py`` configure).
    - ``"offset"``: ``plain`` grid with ``+1e-3`` added to *every element*
      (``range_angle_resp.py:31-34``, ``range_angle_resp_dbs_enhanced.py``).
    - ``"linspace"``: ``linspace(0, range_max, N)``
      (``strip_map_SAR_processor.py:77-81``,
      ``simple_synthetic_array_beamformer_processor_multiFrame.py:182-186``).
    """
    res = cfg.range_res_m
    rmax = cfg.range_max_m
    if variant == "plain":
        return np.arange(start=0, step=res, stop=rmax - res / 2)
    if variant == "eps":
        return np.arange(start=0, step=res, stop=rmax - res / 2 + 1e-3)
    if variant == "offset":
        return np.arange(start=0, step=res, stop=rmax - res / 2) + 1e-3
    if variant == "linspace":
        return np.linspace(start=0, stop=rmax, num=cfg.num_adc_samples)
    raise ValueError(f"unknown range-bin variant {variant!r}")


def vel_bins(cfg: RadarConfig) -> np.ndarray:
    """Velocity (Doppler) bin centers in m/s, ``frame.loops`` entries.

    Reference: ``range_doppler_resp.py:37-41`` — ``arange(-vmax,
    vmax - vres + 1e-3, vres)``, matching a ``fftshift``-ed Doppler FFT of
    ``loops`` chirps.
    """
    return np.arange(
        start=-cfg.vel_max_m_s,
        stop=cfg.vel_max_m_s - cfg.vel_res_m_s + 1e-3,
        step=cfg.vel_res_m_s,
    )


def phase_shift_bins(num_angle_bins: int) -> np.ndarray:
    """Uniform phase-shift grid from pi down to -pi with the endpoint pinned.

    Reference: ``range_angle_resp.py:38-45`` — an ``arange`` with step
    ``-2*pi/(N-1)`` whose last entry is rounded to exactly ``-pi``.
    """
    step = 2 * np.pi / (num_angle_bins - 1)
    ps = np.arange(start=np.pi, stop=-np.pi - step, step=-step)
    ps = ps[:num_angle_bins]
    ps[-1] = -np.pi
    return ps


def angle_bins(num_angle_bins: int) -> np.ndarray:
    """Angle bins ``arcsin(delta_phi / pi)`` for a lambda/2-spaced array.

    Monotonically decreasing from +pi/2 to -pi/2 (reference
    ``range_angle_resp.py:48``).
    """
    return np.arcsin(phase_shift_bins(num_angle_bins) / np.pi)


def time_bins(cfg: RadarConfig, num_frames_history: int) -> np.ndarray:
    """Micro-Doppler history time axis (reference ``micro_doppler_resp.py:82-87``)."""
    frame_period = cfg.frame.periodicity_ms * 1e-3
    return np.linspace(0, num_frames_history * frame_period, num_frames_history)


def polar_mesh(range_bins_m: np.ndarray, angle_bins_rad: np.ndarray):
    """Cartesian mesh (x forward, y left) for a polar range-angle map.

    Returns ``(thetas, rhos, x, y)`` with ``meshgrid(angle, range)`` ordering
    (reference ``range_angle_resp.py:51-53``).
    """
    thetas, rhos = np.meshgrid(angle_bins_rad, range_bins_m)
    return thetas, rhos, rhos * np.cos(thetas), rhos * np.sin(thetas)
