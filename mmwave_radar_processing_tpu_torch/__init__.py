"""mmwave_radar_processing_tpu_torch — the PyTorch/CUDA port of the radar framework.

A second package beside the JAX reference ``mmwave_radar_processing_tpu``,
mirroring its layout module for module.  It imports ``torch`` and never
``jax``; the jax-free host layers of the JAX package (``config``, ``data``,
``utils.verify``) are reused by import, not copied: ``load_cfg`` and
``make_inputs`` (seeded simulated raw frames, numpy only) are re-exported
here, so a driver of the port names only the port.

What is ported so far: the point-cloud main path (``union`` dataflow), the
ego-velocity pipeline (coarse and precise), the combined pipeline, and the
Capon/Bartlett beamforming path (batched pipeline and per-frame processors).

- ``ops.dft``       — DFT factor matrices and the spectral stages
                      (JAX: ``ops/mxu.py``).
- ``ops.cfar``      — counting OS-CFAR 2D detection (JAX: ``ops/cfar.py``).
- ``ops.doppler_az`` — Doppler-azimuth responses of antenna sub-arrays
                      (JAX: ``ops/pallas/doppler_az.py``).
- ``ops.beamform``  — steering matrices, covariance, Bartlett and Capon
                      spectra (JAX: ``ops/beamform.py``,
                      ``ops/pallas/capon.py``, ``ops/pallas/beamform.py``).
- ``ops.kernels``   — the hand-written CUDA kernels behind ``ops.cfar``,
                      ``ops.doppler_az`` and ``ops.beamform``, and their
                      ``nvcc`` build.
- ``ops.peaks``     — local maxima and prominent peaks (JAX: ``ops/peaks.py``).
- ``ops.ransac``    — batched fixed-trial RANSAC (JAX: ``ops/ransac.py``).
- ``ops.masked``    — fixed-capacity compaction (JAX: ``ops/masked.py``).
- ``processors``    — ``reformat``, ``spherical_to_cartesian_flu``, the
                      ODS velocity sub-arrays, the ``Processor`` base and the
                      Bartlett and Capon beamformer processors.
- ``parallel``      — ``build_point_cloud_pipeline``, ``build_velocity_pipeline``,
                      ``build_full_pipeline`` and ``build_capon_pipeline``,
                      each an ``nn.Module``.

Precision is full float32 with TF32 off; there is no reduced-precision mode.
"""

from mmwave_radar_processing_tpu.config import RadarConfig, grids, load_cfg
from mmwave_radar_processing_tpu.utils.verify import make_inputs
from mmwave_radar_processing_tpu_torch.parallel.capon_pipeline import (
    CaponPipeline,
    build_capon_pipeline,
    load_capon_constants,
)
from mmwave_radar_processing_tpu_torch.parallel.full_pipeline import (
    FullPipeline,
    build_full_pipeline,
)
from mmwave_radar_processing_tpu_torch.parallel.pipeline import (
    PointCloudBatch,
    PointCloudPipeline,
    build_point_cloud_pipeline,
    load_reference_constants,
    set_full_fp32,
)
from mmwave_radar_processing_tpu_torch.parallel.velocity_pipeline import (
    VelocityBatch,
    VelocityPipeline,
    build_velocity_pipeline,
    load_velocity_constants,
)
from mmwave_radar_processing_tpu_torch.processors.beamforming import (
    BartlettBeamformerProcessor,
    CaponBeamformerProcessor,
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
    "VelocityBatch",
    "VelocityPipeline",
    "build_velocity_pipeline",
    "load_velocity_constants",
    "FullPipeline",
    "build_full_pipeline",
    "CaponPipeline",
    "build_capon_pipeline",
    "load_capon_constants",
    "BartlettBeamformerProcessor",
    "CaponBeamformerProcessor",
]
