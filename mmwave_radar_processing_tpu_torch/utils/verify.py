"""Seeded simulated input frames (JAX: ``utils/verify.py`` ``make_inputs``).

The port's own copy of the one function of the JAX package's verification
harness that the port uses: numpy only, bit-equal from the same seed.
"""

from __future__ import annotations

import numpy as np

from mmwave_radar_processing_tpu_torch.data import (
    PointTarget,
    ground_scene,
    simulate_frames,
)


def make_inputs(cfg, batch: int, seed: int = 7):
    """Deterministic simulated down-facing frames.

    Ground cone + nadir return (what the altimeter/velocity paths expect)
    plus 1-3 discrete point targets per frame, so CFAR detections, AoA picks
    and RANSAC fits all exercise their real code paths.

    Returns ``(raw_re, raw_im, altitudes)``: float32 planes
    ``[batch, rx, samples, chirps]`` and float32 ``[batch]`` altitudes.
    """
    rng = np.random.default_rng(seed)
    scenes = []
    for i in range(batch):
        alt = 0.9 + 0.4 * rng.random()
        scene = ground_scene(
            cfg, altitude_m=alt,
            ego_vel=(0.3 * rng.standard_normal(), 0.2 * rng.standard_normal(),
                     0.1 * rng.standard_normal()),
            num_patches=32, rng=rng,
        )
        for _ in range(int(rng.integers(1, 4))):
            scene.targets.append(PointTarget(
                range_m=float(rng.uniform(0.4, 0.9) * cfg.range_max_m),
                azimuth_rad=float(rng.uniform(-0.8, 0.8)),
                elevation_rad=float(rng.uniform(-0.4, 0.4)),
                velocity_m_s=float(rng.uniform(-0.5, 0.5) * cfg.vel_max_m_s),
                rcs=float(rng.uniform(2.0, 8.0)),
            ))
        scenes.append(scene)
    raw = simulate_frames(cfg, scenes, rng=np.random.default_rng(seed + 1))
    raw_re = np.ascontiguousarray(raw.real, np.float32)
    raw_im = np.ascontiguousarray(raw.imag, np.float32)
    altitudes = (0.9 + 0.4 * np.random.default_rng(seed + 2)
                 .random(batch)).astype(np.float32)
    return raw_re, raw_im, altitudes
