"""Frame-batched pipelines of the port, each an ``nn.Module`` built by a ``build_*`` function on an explicit ``device``.

- ``pipeline``          — raw cubes -> point clouds (the main path).
- ``velocity_pipeline`` — ADC-domain ego velocity, coarse and precise.
- ``full_pipeline``     — point clouds and velocity from one range DFT.
- ``capon_pipeline``    — Capon / Bartlett range-azimuth heatmaps.
- ``ground_pipeline``   — the altimeter-gated ground scan over a recording.
- ``spectral_pipeline`` — range-Doppler, range-angle and Doppler-azimuth
  maps, micro-Doppler spectrograms, strip-map SAR and DBS maps.
- ``beamform_pipeline`` — synthetic-aperture beamforming over a recording.
- ``viewer_pipeline``   — the viewer's payloads of a whole recording, the
  ground detector's gated tail and the DBS stage.
- ``recording``         — a CPSL recording served batch by batch through the
  combined, point-cloud or ground pipeline (imported as a module).

The multi-device layer runs one process a rank on ``torch.distributed``
(each imported as a module, apart from the three exports below):

- ``launch``            — ``spawn``: ranks through a file store, results and
  tracebacks back to the caller; the backend rule (NCCL or gloo).
- ``mesh``              — ``make_mesh`` (a named ``DeviceMesh``) and the
  rank's share of a global batch; ``collectives`` — the halo shifts and
  ``psum`` on one axis's group, with gloo's host staging.
- ``halo_cfar``, ``overlap_save``, ``sharded_beamform`` — CFAR with a halo
  exchange, the overlap-save zoom (``build_sharded_zoom_fir``), element- and
  snapshot-sharded beamforming.
- ``pipeline.shard_pipeline`` — a frame-batched pipeline on the rank's
  frames; ``input_feed`` — each rank's own NPY loads.
- ``scaling``, ``dryrun``, ``rank_checks`` — the weak-scaling harness, one
  step of the whole program, and the checks that the tests and
  ``chip_smoke.py`` run on every rank.
"""

from mmwave_radar_processing_tpu_torch.parallel.mesh import make_mesh
from mmwave_radar_processing_tpu_torch.parallel.pipeline import (
    PointCloudBatch,
    build_point_cloud_pipeline,
    shard_pipeline,
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
from mmwave_radar_processing_tpu_torch.parallel.overlap_save import build_sharded_zoom_fir
from mmwave_radar_processing_tpu_torch.parallel.viewer_pipeline import (
    build_dbs_viewer_stage,
    build_ground_detector_stage,
    build_viewer_payload_pipeline,
)

__all__ = [
    "make_mesh",
    "PointCloudBatch",
    "build_point_cloud_pipeline",
    "shard_pipeline",
    "build_sharded_zoom_fir",
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
    "build_viewer_payload_pipeline",
    "build_ground_detector_stage",
    "build_dbs_viewer_stage",
]
