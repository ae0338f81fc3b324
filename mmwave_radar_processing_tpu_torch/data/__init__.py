"""Data layer of the port: the synthetic FMCW scene simulator and the recording readers.

- ``simulator``      — the port's own copy of the JAX package's
                       ``data/simulator.py``: point-target scenes to raw ADC
                       cubes with known ground truth (numpy only).
- ``cpsl_dataset``   — ``CpslDS``, the folder-of-NPY recording reader, and
                       ``write_dataset`` / ``make_odom_rows`` to write one
                       (numpy only).
- ``native_loader``  — the NPY bulk loader (``native/npy_loader.cpp``, built
                       with ``g++`` at first use) filling split re/im batches,
                       and its double-buffered prefetcher.  Import it as a
                       module: importing the package builds nothing.
"""

from mmwave_radar_processing_tpu_torch.data.cpsl_dataset import (
    CpslDS,
    make_odom_rows,
    write_dataset,
)
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
    "CpslDS",
    "make_odom_rows",
    "write_dataset",
    "ArrayGeometry",
    "PointTarget",
    "Scene",
    "ground_scene",
    "ods_geometry",
    "simulate_frame",
    "simulate_frames",
    "standard_geometry",
]
