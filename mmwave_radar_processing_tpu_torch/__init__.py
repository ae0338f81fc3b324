"""mmwave_radar_processing_tpu_torch — the PyTorch/CUDA port of the radar framework.

A second package beside the JAX reference ``mmwave_radar_processing_tpu``,
mirroring its layout module for module.  It imports ``torch``, never ``jax``
and nothing of the JAX package: the host layers it needs (``config``,
``data.simulator``, ``utils.verify.make_inputs``; numpy only) are its own
copies, held bit-equal to the originals by the tests.  ``load_cfg`` and
``make_inputs`` (seeded simulated raw frames) are exported here, so a script
that runs the port names only the port.

What is ported so far: the point-cloud main path (``union`` dataflow), the
ego-velocity pipeline (coarse and precise), the combined pipeline, the
Capon/Bartlett beamforming path (batched pipeline and per-frame processors),
the detector API (CFAR threshold maps, the CFAR detector classes, the
range and range-Doppler detectors, the altimeter and the point-cloud
generator), the altimeter-gated ground scan, the velocity object API
(the Doppler-azimuth processor, the ADC-domain velocity estimator and the
points estimators), the spectral-map family (range-angle,
micro-Doppler, strip-map SAR, DBS and synthetic-aperture processors and
their batched pipelines), and the recording path (the CPSL reader, the
NPY bulk loader, the recording runner, stage timing, checkpoints and the
velocity analyzers), and the viewer's device side and headless backend
(the batched payload pipelines, the playback controller and its
precompute-then-scrub cache).  Every ``build_*`` function, class and runner
takes an explicit ``device``; the playback controller's defaults to CUDA.

- ``config``, ``data``, ``utils.verify`` — configuration parsing and grids,
                      the scene simulator, the CPSL recording reader and
                      the NPY bulk loader, seeded input frames.
- ``utils``         — logger, ``.env`` roots, rotations, ``StageTimer``
                      and tracing, state checkpoints.
- ``analysis``      — velocity error statistics and the per-frame
                      velocity-analysis flow over a recording.
- ``ops.dft``       — DFT factor matrices and the spectral stages
                      (JAX: ``ops/mxu.py``).
- ``ops.cfar``      — CA/GO/SO/OS threshold maps, 1D and 2D, and counting
                      OS-CFAR detection (JAX: ``ops/cfar.py``).
- ``ops.czt``       — chirp-z (zoom) transform (JAX: ``ops/czt.py``).
- ``ops.doppler_az`` — Doppler-azimuth responses of antenna sub-arrays
                      (JAX: ``ops/pallas/doppler_az.py``).
- ``ops.beamform``  — steering matrices, covariance, Bartlett and Capon
                      spectra (JAX: ``ops/beamform.py``,
                      ``ops/pallas/capon.py``, ``ops/pallas/beamform.py``).
- ``ops.altitude``  — the ground scan's altitude recursion (JAX: the
                      ``lax.scan`` of ``parallel/ground_pipeline.py``).
- ``ops.kernels``   — the hand-written CUDA kernels behind ``ops.cfar``,
                      ``ops.doppler_az``, ``ops.beamform`` and
                      ``ops.altitude``, and their ``nvcc`` build.
- ``ops.peaks``     — local maxima, prominences and peak picking (JAX:
                      ``ops/peaks.py``).
- ``ops.ransac``    — batched fixed-trial RANSAC (JAX: ``ops/ransac.py``).
- ``ops.masked``    — fixed-capacity compaction (JAX: ``ops/masked.py``).
- ``detectors``     — the six CFAR detector classes and their registry.
- ``processors``    — ``VirtualArrayReformatter``, ``RangeProcessor``,
                      ``RangeDopplerProcessor``, ``Altimeter``,
                      ``RangeDetector``, the range-Doppler detectors,
                      ``PointCloudGenerator``, ``DopplerAzimuthProcessor``,
                      ``VelocityEstimator``, the Bartlett and Capon
                      beamformer processors, ``RangeAngleProcessor``,
                      ``MicroDopplerProcessor``, ``StripMapSARProcessor``,
                      ``RangeAngleProcessorDBSEnhanced`` and
                      ``SyntheticArrayBeamformerProcessor``.
- ``point_cloud_processing`` — ego velocity from points: ``VelocityEstimator``
                      and ``VehicleVelEstimator``.
- ``parallel``      — ``build_point_cloud_pipeline``, ``build_velocity_pipeline``,
                      ``build_full_pipeline``, ``build_capon_pipeline``,
                      ``build_ground_point_cloud_pipeline``,
                      ``build_velocity_analysis_pipeline`` (the ground scan
                      and the points' ego velocity over a recording),
                      ``build_spectral_maps_pipeline``,
                      ``build_micro_doppler_pipeline``,
                      ``build_strip_map_pipeline``, ``build_dbs_pipeline`` and
                      ``build_synthetic_aperture_pipeline``, each an
                      ``nn.Module``; ``parallel.recording.process_recording``
                      serves a recording through the combined, point-cloud
                      or ground pipeline; ``build_viewer_payload_pipeline``,
                      ``build_ground_detector_stage`` and
                      ``build_dbs_viewer_stage`` serve the viewer.
- ``visualization`` — the processor registry, the playback controller, the
                      precompute cache and the view grid's model (no
                      drawing; nothing imports PyYAML, matplotlib or Qt at
                      module level).

Precision is full float32 with TF32 off; there is no reduced-precision mode.
"""

__version__ = "0.1.0"

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids, load_cfg
from mmwave_radar_processing_tpu_torch.utils.verify import make_inputs
from mmwave_radar_processing_tpu_torch.parallel.capon_pipeline import (
    CaponPipeline,
    build_capon_pipeline,
    load_capon_constants,
)
from mmwave_radar_processing_tpu_torch.parallel.ground_pipeline import (
    GroundPipeline,
    GroundPipelineOut,
    build_ground_point_cloud_pipeline,
)
from mmwave_radar_processing_tpu_torch.parallel.velocity_analysis_pipeline import (
    VelocityAnalysisOut,
    VelocityAnalysisPipeline,
    build_velocity_analysis_pipeline,
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
from mmwave_radar_processing_tpu_torch.parallel.velocity_pipeline import (
    VelocityBatch,
    VelocityPipeline,
    build_velocity_pipeline,
    load_velocity_constants,
)
from mmwave_radar_processing_tpu_torch.detectors import get_detector_registry
from mmwave_radar_processing_tpu_torch.processors import (
    Altimeter,
    AltimeterState,
    BartlettBeamformerProcessor,
    CaponBeamformerProcessor,
    MicroDopplerProcessor,
    PointCloudGenerator,
    RangeAngleProcessor,
    RangeAngleProcessorDBSEnhanced,
    RangeDetector,
    RangeDopplerDetector2D,
    RangeDopplerDetectorSequential,
    RangeDopplerGroundDetector,
    RangeDopplerProcessor,
    RangeProcessor,
    StripMapSARProcessor,
    SyntheticArrayBeamformerProcessor,
    SyntheticArrayState,
    VirtualArrayReformatter,
    get_range_doppler_detector_registry,
    load_detection_constants,
)

__all__ = [
    "__version__",
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
    "GroundPipeline",
    "GroundPipelineOut",
    "build_ground_point_cloud_pipeline",
    "VelocityAnalysisOut",
    "VelocityAnalysisPipeline",
    "build_velocity_analysis_pipeline",
    "CaponPipeline",
    "build_capon_pipeline",
    "load_capon_constants",
    "BartlettBeamformerProcessor",
    "CaponBeamformerProcessor",
    "get_detector_registry",
    "VirtualArrayReformatter",
    "RangeProcessor",
    "RangeDopplerProcessor",
    "Altimeter",
    "AltimeterState",
    "RangeDetector",
    "RangeDopplerDetector2D",
    "RangeDopplerDetectorSequential",
    "RangeDopplerGroundDetector",
    "get_range_doppler_detector_registry",
    "PointCloudGenerator",
    "load_detection_constants",
    "SpectralMaps",
    "SpectralMapsPipeline",
    "MicroDopplerPipeline",
    "StripMapPipeline",
    "DBSPipeline",
    "build_spectral_maps_pipeline",
    "build_micro_doppler_pipeline",
    "build_strip_map_pipeline",
    "build_dbs_pipeline",
    "SyntheticAperturePipeline",
    "build_synthetic_aperture_pipeline",
    "RangeAngleProcessor",
    "MicroDopplerProcessor",
    "StripMapSARProcessor",
    "RangeAngleProcessorDBSEnhanced",
    "SyntheticArrayBeamformerProcessor",
    "SyntheticArrayState",
]
