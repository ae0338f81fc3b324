"""Inputs for the tests of the synthetic-aperture steering phases: the RadSAR cell's widths.

No JAX: the card's tests import this too.  The steering vectors are the
azimuth-major grid the pipeline builds, the positions the pipeline's own
chained geometry of a cruise, so the angles reach the ~500 rad the cell's
phases take.
"""

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.processors.synthetic_array import chained_geometry

#: the IWR1843's wavelength at its 77 GHz start frequency
LAMBDA_M = 0.0038934085454545454
#: the kernel against its plain version: float32 angles of up to ~500 rad
#: hold a rounding of ~3e-5 a step, and a few ulp of the angle move the
#: phase by that much
STEERING_ATOL = 1e-4


def steering_grid(n_az=60, n_el=16):
    """float32 ``(n_az * n_el, 3)`` unit vectors over ±30° of azimuth and ±15° of elevation."""
    th, ph = np.meshgrid(np.deg2rad(np.linspace(-30, 30, n_az)),
                         np.deg2rad(np.linspace(-15, 15, n_el)), indexing="ij")
    d = np.stack([np.cos(th) * np.cos(ph), np.sin(th) * np.cos(ph), np.sin(ph)], axis=-1)
    return torch.from_numpy(d.reshape(-1, 3).astype(np.float32))


def cruise_positions(frames, num_frames=8, chirps=100, seed=0):
    """float32 ``[frames, 3, num_frames * chirps]`` positions of a cruise at ~0.21 m/s."""
    rng = np.random.default_rng(seed)
    vel = np.array([0.21, 0.0, 0.0]) + 0.01 * rng.standard_normal((frames, num_frames, 3))
    chirp_times = -np.arange(chirps - 1, -1, -1) * 200e-6
    geometry = chained_geometry(torch.from_numpy(vel.astype(np.float32)),
                                torch.from_numpy(chirp_times.astype(np.float32)), 0.1)
    return geometry.transpose(1, 2).reshape(frames, 3, -1)
