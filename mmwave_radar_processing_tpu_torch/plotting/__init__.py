"""Presentation layer: matplotlib dashboards and movie export (JAX: ``plotting/``).

The processors run on their device; these classes draw their results on
the host, each passing what it draws through ``processors.base.to_host``.
matplotlib and imageio are imported when something is drawn or written,
never when this package is imported.

- :class:`PlotterMmWaveData` — per-frame heatmaps (range-azimuth cartesian
  and polar, range-Doppler, micro-Doppler, Doppler-azimuth, range profile,
  raw ADC) and the 2x3 dashboard.
- :class:`PlotterOdometryData` — altimeter and velocity-against-truth panels.
- :class:`PlotterSyntheticArrayData` — synthetic-array geometry, beamformed
  slices, cartesian SAR image, array pattern, depth map.
- :class:`AnalysisPlotter` — error CDFs, histograms, time series, summaries.
- :class:`MovieGenerator` and its three generators — a figure a frame, to
  mp4 (GIF without ffmpeg); each generator's ``compute_frame_panels`` is
  the device half of a frame.
"""

from mmwave_radar_processing_tpu_torch.plotting.analysis_plotter import AnalysisPlotter
from mmwave_radar_processing_tpu_torch.plotting.movie_generator import (
    MmWaveDataMovieGenerator,
    MovieGenerator,
    OdometryMovieGenerator,
    SyntheticArrayMovieGenerator,
)
from mmwave_radar_processing_tpu_torch.plotting.plotter_mmwave_data import PlotterMmWaveData
from mmwave_radar_processing_tpu_torch.plotting.plotter_odometry import PlotterOdometryData
from mmwave_radar_processing_tpu_torch.plotting.plotter_synthetic_array import (
    PlotterSyntheticArrayData,
)

# the reference's class names
MovieGeneratorMmWaveData = MmWaveDataMovieGenerator
MovieGeneratorOdometry = OdometryMovieGenerator
MovieGeneratorSyntheticArrayData = SyntheticArrayMovieGenerator

__all__ = [
    "MovieGeneratorMmWaveData",
    "MovieGeneratorOdometry",
    "MovieGeneratorSyntheticArrayData",
    "PlotterMmWaveData",
    "PlotterOdometryData",
    "PlotterSyntheticArrayData",
    "AnalysisPlotter",
    "MovieGenerator",
    "MmWaveDataMovieGenerator",
    "OdometryMovieGenerator",
    "SyntheticArrayMovieGenerator",
]
