"""Signal-processing stages of the port (JAX: ``processors/``).

Each processor is a config-bound object that holds its constants on an
explicit ``device`` and whose ``process`` methods are plain tensor code.
Stateless stages are functions of the ADC cube; the stateful ones (the
altimeter's tracked altitude, the micro-Doppler history, the
synthetic-aperture ring buffers) are an explicit state with
``init_state()`` and a functional ``step(state, ...) -> (state, out)``.
"""

from mmwave_radar_processing_tpu_torch.processors.altimeter import (
    Altimeter,
    AltimeterState,
)
from mmwave_radar_processing_tpu_torch.processors.beamforming import (
    BartlettBeamformerProcessor,
    CaponBeamformerProcessor,
)
from mmwave_radar_processing_tpu_torch.processors.dbs import (
    RangeAngleProcessorDBSEnhanced,
)
from mmwave_radar_processing_tpu_torch.processors.detection import (
    Detections,
    RangeDetector,
    RangeDopplerDetector2D,
    RangeDopplerDetectorSequential,
    RangeDopplerGroundDetector,
    get_range_doppler_detector_registry,
)
from mmwave_radar_processing_tpu_torch.processors.doppler_azimuth import (
    DopplerAzimuthProcessor,
)
from mmwave_radar_processing_tpu_torch.processors.micro_doppler import (
    MicroDopplerProcessor,
)
from mmwave_radar_processing_tpu_torch.processors.point_cloud import (
    PointCloud,
    PointCloudGenerator,
    load_detection_constants,
)
from mmwave_radar_processing_tpu_torch.processors.range_angle import (
    RangeAngleProcessor,
)
from mmwave_radar_processing_tpu_torch.processors.range_doppler import (
    RangeDopplerProcessor,
)
from mmwave_radar_processing_tpu_torch.processors.range_resp import RangeProcessor
from mmwave_radar_processing_tpu_torch.processors.strip_map_sar import (
    StripMapSARProcessor,
)
from mmwave_radar_processing_tpu_torch.processors.synthetic_array import (
    SyntheticArrayBeamformerProcessor,
    SyntheticArrayState,
)
from mmwave_radar_processing_tpu_torch.processors.velocity_estimator import (
    VelocityEstimator,
)
from mmwave_radar_processing_tpu_torch.processors.virtual_array import (
    VirtualArrayReformatter,
)

__all__ = [
    "VirtualArrayReformatter",
    "RangeProcessor",
    "RangeDopplerProcessor",
    "RangeAngleProcessor",
    "MicroDopplerProcessor",
    "Altimeter",
    "AltimeterState",
    "Detections",
    "RangeDetector",
    "RangeDopplerDetector2D",
    "RangeDopplerDetectorSequential",
    "RangeDopplerGroundDetector",
    "get_range_doppler_detector_registry",
    "PointCloud",
    "PointCloudGenerator",
    "load_detection_constants",
    "BartlettBeamformerProcessor",
    "CaponBeamformerProcessor",
    "DopplerAzimuthProcessor",
    "VelocityEstimator",
    "RangeAngleProcessorDBSEnhanced",
    "StripMapSARProcessor",
    "SyntheticArrayBeamformerProcessor",
    "SyntheticArrayState",
]
