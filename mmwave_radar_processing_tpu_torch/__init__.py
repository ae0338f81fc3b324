"""mmwave_radar_processing_tpu_torch — the PyTorch/CUDA port of the radar framework.

A second package beside the JAX reference ``mmwave_radar_processing_tpu``,
mirroring its layout module for module.  It imports ``torch`` and never
``jax``; the jax-free host layers of the JAX package (``config``, ``data``,
``utils.verify``) are reused by import, not copied: ``load_cfg`` and
``make_inputs`` (seeded simulated raw frames, numpy only) are re-exported
here, so a driver of the port names only the port.

What is ported so far is the point-cloud main path (``union`` dataflow):

- ``ops.dft``       — DFT factor matrices and the spectral stages
                      (JAX: ``ops/mxu.py``).
- ``ops.cfar``      — counting OS-CFAR 2D detection (JAX: ``ops/cfar.py``).
- ``ops.kernels``   — the hand-written CUDA kernel behind ``ops.cfar`` and its
                      ``nvcc`` build (JAX: ``ops/pallas/os_cfar.py``).
- ``ops.masked``    — fixed-capacity compaction (JAX: ``ops/masked.py``).
- ``processors``    — ``reformat`` and ``spherical_to_cartesian_flu``.
- ``parallel.pipeline`` — ``build_point_cloud_pipeline``: raw cubes -> point
                      clouds, as an ``nn.Module``.

Precision is full float32 with TF32 off; there is no reduced-precision mode.
"""

from mmwave_radar_processing_tpu.config import RadarConfig, grids, load_cfg
from mmwave_radar_processing_tpu.utils.verify import make_inputs
from mmwave_radar_processing_tpu_torch.parallel.pipeline import (
    PointCloudBatch,
    PointCloudPipeline,
    build_point_cloud_pipeline,
    load_reference_constants,
    set_full_fp32,
)

__all__ = [
    "RadarConfig",
    "grids",
    "load_cfg",
    "make_inputs",
    "PointCloudBatch",
    "PointCloudPipeline",
    "build_point_cloud_pipeline",
    "load_reference_constants",
    "set_full_fp32",
]
