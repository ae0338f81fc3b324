"""Processor registry: the spec dataclass and the default table of fourteen processors (JAX: ``visualization/processor_registry.py``).

Each row binds a processor class of the port to its view, declares the
inputs it needs (velocity), the history depth it keeps, and which processor
attributes go into the view's payload (the ``view_keys`` payload protocol).
The rows equal the JAX package's; the classes are the port's, built on the
controller's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Type

from mmwave_radar_processing_tpu_torch.processors.altimeter import Altimeter
from mmwave_radar_processing_tpu_torch.processors.beamforming import (
    BartlettBeamformerProcessor,
    CaponBeamformerProcessor,
)
from mmwave_radar_processing_tpu_torch.processors.dbs import RangeAngleProcessorDBSEnhanced
from mmwave_radar_processing_tpu_torch.processors.detection import (
    RangeDetector,
    RangeDopplerDetector2D,
    RangeDopplerDetectorSequential,
    RangeDopplerGroundDetector,
)
from mmwave_radar_processing_tpu_torch.processors.doppler_azimuth import (
    DopplerAzimuthProcessor,
)
from mmwave_radar_processing_tpu_torch.processors.micro_doppler import MicroDopplerProcessor
from mmwave_radar_processing_tpu_torch.processors.point_cloud import PointCloudGenerator
from mmwave_radar_processing_tpu_torch.processors.range_angle import RangeAngleProcessor
from mmwave_radar_processing_tpu_torch.processors.range_doppler import RangeDopplerProcessor
from mmwave_radar_processing_tpu_torch.processors.range_resp import RangeProcessor


@dataclass
class ProcessorSpec:
    """One registry row: processor <-> view pairing and payload contract."""

    key: str
    display_name: str
    processor_cls: Type
    view_name: str
    required_inputs: Tuple[str, ...] = ()
    output_schema: str = "heatmap"
    enabled: bool = True
    requires_velocity: bool = False
    num_frames_history: int = 1
    view_keys: Tuple[str, ...] = ()


def get_default_registry() -> Dict[str, ProcessorSpec]:
    """The default processors, by key (a fresh table on every call)."""
    specs = [
        ProcessorSpec(
            key="range_doppler_resp", display_name="Range-Doppler",
            processor_cls=RangeDopplerProcessor, view_name="range_doppler",
            view_keys=("range_bins", "vel_bins"),
        ),
        ProcessorSpec(
            key="range_resp", display_name="Range Response",
            processor_cls=RangeProcessor, view_name="range_response",
            output_schema="curve", view_keys=("range_bins",),
        ),
        ProcessorSpec(
            key="range_angle_resp", display_name="Range-Angle",
            processor_cls=RangeAngleProcessor, view_name="range_angle",
            view_keys=("range_bins", "angle_bins", "x_s", "y_s"),
        ),
        ProcessorSpec(
            key="range_angle_resp_dbs_enhanced", display_name="Range-Angle (DBS)",
            processor_cls=RangeAngleProcessorDBSEnhanced, view_name="range_angle",
            requires_velocity=True,
            view_keys=("range_bins", "angle_bins", "x_s", "y_s"),
        ),
        ProcessorSpec(
            key="micro_doppler_resp", display_name="Micro-Doppler",
            processor_cls=MicroDopplerProcessor, view_name="micro_doppler",
            num_frames_history=20, view_keys=("vel_bins", "time_bins"),
        ),
        ProcessorSpec(
            key="doppler_azimuth_resp", display_name="Doppler-Azimuth",
            processor_cls=DopplerAzimuthProcessor, view_name="doppler_azimuth",
            view_keys=("vel_bins", "valid_angle_bins", "zoomed_vel_bins"),
        ),
        ProcessorSpec(
            key="range_doppler_detector_2d", display_name="RD Detector (2D CFAR)",
            processor_cls=RangeDopplerDetector2D, view_name="range_doppler_detector",
            output_schema="detections",
            view_keys=("range_bins", "vel_bins", "rng_dop_resp"),
        ),
        ProcessorSpec(
            key="range_doppler_detector_sequential",
            display_name="RD Detector (sequential)",
            processor_cls=RangeDopplerDetectorSequential,
            view_name="range_doppler_detector", output_schema="detections",
            view_keys=("range_bins", "vel_bins", "rng_dop_resp"),
        ),
        ProcessorSpec(
            key="range_doppler_ground_detector", display_name="RD Ground Detector",
            processor_cls=RangeDopplerGroundDetector,
            view_name="range_doppler_detector", output_schema="detections",
            view_keys=("range_bins", "vel_bins", "rng_dop_resp"),
        ),
        ProcessorSpec(
            key="range_detector", display_name="Range Detector",
            processor_cls=RangeDetector, view_name="range_detector",
            output_schema="detections",
            view_keys=("range_bins", "range_resp", "thresholds"),
        ),
        ProcessorSpec(
            key="altimeter", display_name="Altimeter",
            processor_cls=Altimeter, view_name="altitude",
            output_schema="scalar", view_keys=("range_bins", "coarse_fft_data"),
        ),
        ProcessorSpec(
            key="point_cloud_generator", display_name="Point Cloud",
            processor_cls=PointCloudGenerator, view_name="point_cloud",
            output_schema="points", view_keys=(),
        ),
        # the Capon and Bartlett beamformers: the range-angle view's payload
        # contract, so that view renders them unchanged
        ProcessorSpec(
            key="bartlett_beamformer", display_name="Range-Azimuth (Bartlett)",
            processor_cls=BartlettBeamformerProcessor, view_name="range_angle",
            view_keys=("range_bins", "angle_bins", "x_s", "y_s"),
        ),
        ProcessorSpec(
            key="capon_beamformer", display_name="Range-Azimuth (Capon)",
            processor_cls=CaponBeamformerProcessor, view_name="range_angle",
            view_keys=("range_bins", "angle_bins", "x_s", "y_s"),
        ),
    ]
    return {s.key: s for s in specs}
