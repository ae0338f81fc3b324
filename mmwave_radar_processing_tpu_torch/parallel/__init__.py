"""Frame-batched pipelines of the port, each an ``nn.Module`` built by a ``build_*`` function on an explicit ``device``.

- ``pipeline``          — raw cubes -> point clouds (the main path).
- ``velocity_pipeline`` — ADC-domain ego velocity, coarse and precise.
- ``full_pipeline``     — point clouds and velocity from one range DFT.
- ``capon_pipeline``    — Capon / Bartlett range-azimuth heatmaps.
- ``ground_pipeline``   — the altimeter-gated ground scan over a recording.
- ``spectral_pipeline`` — range-Doppler, range-angle and Doppler-azimuth
  maps, micro-Doppler spectrograms, strip-map SAR and DBS maps.
- ``beamform_pipeline`` — synthetic-aperture beamforming over a recording.
"""

from mmwave_radar_processing_tpu_torch.parallel.pipeline import (
    PointCloudBatch,
    build_point_cloud_pipeline,
)
from mmwave_radar_processing_tpu_torch.parallel.velocity_pipeline import (
    VelocityBatch,
    build_velocity_pipeline,
)
from mmwave_radar_processing_tpu_torch.parallel.full_pipeline import build_full_pipeline
from mmwave_radar_processing_tpu_torch.parallel.capon_pipeline import build_capon_pipeline
from mmwave_radar_processing_tpu_torch.parallel.ground_pipeline import (
    GroundPipelineOut,
    build_ground_point_cloud_pipeline,
)
from mmwave_radar_processing_tpu_torch.parallel.beamform_pipeline import (
    SyntheticAperturePipeline,
    build_synthetic_aperture_pipeline,
)
from mmwave_radar_processing_tpu_torch.parallel.spectral_pipeline import (
    DBSPipeline,
    MicroDopplerPipeline,
    SpectralMaps,
    SpectralMapsPipeline,
    StripMapPipeline,
    build_dbs_pipeline,
    build_micro_doppler_pipeline,
    build_spectral_maps_pipeline,
    build_strip_map_pipeline,
)

__all__ = [
    "PointCloudBatch",
    "build_point_cloud_pipeline",
    "VelocityBatch",
    "build_velocity_pipeline",
    "build_full_pipeline",
    "build_capon_pipeline",
    "GroundPipelineOut",
    "build_ground_point_cloud_pipeline",
    "SyntheticAperturePipeline",
    "build_synthetic_aperture_pipeline",
    "SpectralMaps",
    "SpectralMapsPipeline",
    "MicroDopplerPipeline",
    "StripMapPipeline",
    "DBSPipeline",
    "build_spectral_maps_pipeline",
    "build_micro_doppler_pipeline",
    "build_strip_map_pipeline",
    "build_dbs_pipeline",
]
