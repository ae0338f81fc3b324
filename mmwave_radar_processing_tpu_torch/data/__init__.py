"""Data layer of the port: the synthetic FMCW scene simulator (numpy only).

The port's own copy of the JAX package's ``data/simulator.py``: point-target
scenes to raw ADC cubes with known ground truth.  The recording readers
(``cpsl_dataset``, ``native_loader``) are not ported yet.
"""

from mmwave_radar_processing_tpu_torch.data.simulator import (
    ArrayGeometry,
    PointTarget,
    Scene,
    ground_scene,
    ods_geometry,
    simulate_frame,
    simulate_frames,
    standard_geometry,
)

__all__ = [
    "ArrayGeometry",
    "PointTarget",
    "Scene",
    "ground_scene",
    "ods_geometry",
    "simulate_frame",
    "simulate_frames",
    "standard_geometry",
]
