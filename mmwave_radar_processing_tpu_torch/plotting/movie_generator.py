"""Movie export: one figure a dataset frame, written to PNG, then encoded (JAX: ``plotting/movie_generator.py``).

Each generator splits a frame in two halves:

- ``compute_frame_panels(idx)`` runs the frame through the processors on
  their device and returns the frame's panels as host arrays (the
  reformatted cube stays on the device between the processors; only the
  panels are copied);
- ``generate_movie_frame(idx)`` draws the figure of frame ``idx`` from that
  method's result.

``MmWaveDataMovieGenerator`` is the dashboard movie (raw ADC, range-Doppler,
range-azimuth, micro-Doppler, Doppler-azimuth), ``OdometryMovieGenerator``
the altimeter and velocity movie, ``SyntheticArrayMovieGenerator`` the
synthetic-aperture movie.  Movies are mp4 (libx264) where an ffmpeg encoder
exists, GIF otherwise.

matplotlib and imageio are imported where a frame is drawn or written.
There is no ``matplotlib.use("Agg")``: choosing a backend when a module is
imported would override a notebook's for every user of this package
(headless hosts default to Agg).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import numpy as np

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.processors.base import to_host
from mmwave_radar_processing_tpu_torch.utils.logger import get_logger


def _ffmpeg_available() -> bool:
    try:
        import imageio_ffmpeg  # noqa: F401

        return True
    except ImportError:
        return shutil.which("ffmpeg") is not None


def _open_writer_path(out_path: str, logger) -> str:
    """``out_path``, or its ``.gif`` twin when it is an mp4 and no ffmpeg encoder exists."""
    if out_path.endswith(".mp4") and not _ffmpeg_available():
        fallback = out_path[:-4] + ".gif"
        logger.warning("no ffmpeg encoder available; writing %s instead", fallback)
        return fallback
    return out_path


def _open_writer(out_path: str, fps: int):
    import imageio.v2 as imageio

    if out_path.endswith(".gif"):
        return imageio.get_writer(out_path, duration=1.0 / fps)
    return imageio.get_writer(out_path, fps=fps, codec="libx264", quality=8)


def _velocity_ned(dataset, idx: int) -> np.ndarray:
    """The mean odometry velocity, columns 8:11 (zeros without odometry)."""
    if not getattr(dataset, "vehicle_odom_enabled", False):
        return np.zeros(3)
    return np.mean(dataset.get_vehicle_odom_data(idx)[:, 8:11], axis=0)


class MovieGenerator:
    """Render frames to PNGs, then encode them (mp4, or GIF without ffmpeg)."""

    def __init__(self, temp_dir: Optional[str] = None, fps: int = 20):
        self.temp_dir = temp_dir
        self.fps = fps
        self._own_temp = temp_dir is None
        self.frame_paths = []
        self.logger = get_logger(__name__)

    def initialize_temp_directory(self):
        if self._own_temp:
            self.temp_dir = tempfile.mkdtemp(prefix="mmwave_movie_")
        else:
            os.makedirs(self.temp_dir, exist_ok=True)
        self.frame_paths = []

    def save_frame(self, fig, idx: int):
        import matplotlib.pyplot as plt

        path = os.path.join(self.temp_dir, f"frame_{idx:06d}.png")
        fig.savefig(path, dpi=80)
        plt.close(fig)
        self.frame_paths.append(path)

    def compute_frame_panels(self, idx: int) -> dict:
        """Subclass hook: frame ``idx``'s panels, computed on the device, as host arrays."""
        raise NotImplementedError

    def generate_movie_frame(self, idx: int):
        """Subclass hook: the figure of frame ``idx``, drawn from :meth:`compute_frame_panels`."""
        raise NotImplementedError

    def generate_movie_frames(self, num_frames: int, start: int = 0):
        self.initialize_temp_directory()
        for i in range(start, num_frames):
            fig = self.generate_movie_frame(i)
            self.save_frame(fig, i)

    def save_movie(self, out_path: str, fps: Optional[int] = None):
        import imageio.v2 as imageio

        out_path = _open_writer_path(out_path, self.logger)
        writer = _open_writer(out_path, fps or self.fps)
        try:
            for path in self.frame_paths:
                writer.append_data(imageio.imread(path))
        finally:
            writer.close()
        self.logger.info("wrote movie %s (%d frames)", out_path,
                         len(self.frame_paths))
        return out_path

    def cleanup(self):
        if self._own_temp and self.temp_dir and os.path.isdir(self.temp_dir):
            shutil.rmtree(self.temp_dir)


class MmWaveDataMovieGenerator(MovieGenerator):
    """The dashboard movie over a ``CpslDS`` dataset."""

    def __init__(self, config: RadarConfig, dataset, plotter, processors: dict,
                 reformatter=None, **kwargs):
        super().__init__(**kwargs)
        self.config = config
        self.dataset = dataset
        self.plotter = plotter
        self.processors = processors
        self.reformatter = reformatter

    def _velocity_ned(self, idx: int) -> np.ndarray:
        return _velocity_ned(self.dataset, idx)

    def compute_frame_panels(self, idx: int) -> dict:
        """The dashboard's panels of frame ``idx`` as host arrays.

        ``raw_adc``: the cube's receiver 0, chirp 0 samples; one entry for
        each processor present (``range_doppler``, ``range_angle``,
        ``micro_doppler``, ``doppler_azimuth``, ``zoomed_doppler_azimuth``
        with ``zoomed_vel_bins`` and ``zoomed_vel_valid``); ``camera``,
        ``None`` without a camera frame.
        """
        adc = self.dataset.get_radar_adc_data(idx)
        if self.reformatter is not None:
            adc = self.reformatter.process(adc)  # stays on the processors' device
        procs = self.processors
        panels = {"raw_adc": to_host(adc[0, :, 0])}
        if "range_doppler" in procs:
            panels["range_doppler"] = to_host(procs["range_doppler"].process(adc, rx_idx=0))
        for name in ("range_angle", "micro_doppler", "doppler_azimuth"):
            if name in procs:
                panels[name] = to_host(procs[name].process(adc))
        if "zoomed_doppler_azimuth" in procs:
            resp, bins, valid = procs["zoomed_doppler_azimuth"].process(
                adc, use_precise_fft=True)
            panels["zoomed_doppler_azimuth"] = to_host(resp)
            panels["zoomed_vel_bins"] = to_host(bins)
            panels["zoomed_vel_valid"] = to_host(valid)

        panels["camera"] = None
        if getattr(self.dataset, "camera_enabled", False):
            try:
                panels["camera"] = self.dataset.get_camera_frame(idx)
            except AssertionError:
                pass
        return panels

    def generate_movie_frame(self, idx: int):
        panels = self.compute_frame_panels(idx)
        return self.plotter.plot_compilation(
            panels["raw_adc"][None, :, None],
            range_doppler=panels.get("range_doppler"),
            range_angle=panels.get("range_angle"),
            micro_doppler=panels.get("micro_doppler"),
            doppler_azimuth=panels.get("doppler_azimuth"),
            camera_frame=panels["camera"],
            zoomed_doppler_azimuth=panels.get("zoomed_doppler_azimuth"),
            processors=self.processors,
        )

    def generate(self, out_path: str, num_frames: Optional[int] = None):
        n = num_frames or self.dataset.num_frames
        self.generate_movie_frames(n)
        self.save_movie(out_path)
        self.cleanup()


class OdometryMovieGenerator(MovieGenerator):
    """The altimeter and velocity movie.

    Each frame: the altimeter's profile with the tracked altitude, the
    altitude history, and the velocity estimate against the odometry.
    """

    def __init__(self, config: RadarConfig, dataset, altimeter, plotter,
                 reformatter=None, velocity_estimator=None,
                 point_cloud_generator=None, **kwargs):
        super().__init__(**kwargs)
        self.config = config
        self.dataset = dataset
        self.altimeter = altimeter
        self.plotter = plotter
        self.reformatter = reformatter
        self.velocity_estimator = velocity_estimator
        self.point_cloud_generator = point_cloud_generator
        self.alt_history = []
        self.vel_history = []
        self.gt_vel_history = []

    def compute_frame_panels(self, idx: int) -> dict:
        """Frame ``idx``'s ``altitude`` (float), ``coarse_fft_data``, ``velocity`` and ``gt_velocity`` on the host.

        The altitude's ``float`` waits for the device once a frame.
        """
        adc = self.dataset.get_radar_adc_data(idx)
        if self.reformatter is not None:
            adc = self.reformatter.process(adc)  # stays on the processors' device
        altitude = float(self.altimeter.process(adc))
        if self.velocity_estimator is not None and self.point_cloud_generator is not None:
            pts = self.point_cloud_generator.process(adc)
            vel = to_host(self.velocity_estimator.process(points=pts))
        else:
            vel = np.zeros(3)
        return {"altitude": altitude, "coarse_fft_data": to_host(self.altimeter.coarse_fft_data),
                "velocity": vel, "gt_velocity": _velocity_ned(self.dataset, idx)}

    def generate_movie_frame(self, idx: int):
        import matplotlib.pyplot as plt

        panels = self.compute_frame_panels(idx)
        self.alt_history.append(panels["altitude"])
        self.vel_history.append(panels["velocity"])
        self.gt_vel_history.append(panels["gt_velocity"])

        fig = plt.figure(figsize=(12, 8))
        axes = fig.subplots(2, 2)
        self.plotter.plot_altimeter_profiles(
            panels["coarse_fft_data"], self.altimeter.range_bins,
            altitude_m=panels["altitude"], ax=axes[0, 0],
        )
        self.plotter.plot_altitude_history(
            self.alt_history, ax=axes[0, 1],
            frame_period_s=self.config.frame_period_s,
        )
        est = np.asarray(self.vel_history)
        gt = np.asarray(self.gt_vel_history)
        axes[1, 0].plot(est[:, 0], label="est vx")
        axes[1, 0].plot(gt[:, 0], "--", label="gt vx")
        axes[1, 0].legend(fontsize=8)
        axes[1, 1].plot(np.linalg.norm(est - gt, axis=1))
        axes[1, 1].set_title("velocity |error|", fontsize=9)
        fig.tight_layout()
        return fig


class SyntheticArrayMovieGenerator(MovieGenerator):
    """The synthetic-aperture movie: the beamformer takes the mean vehicle velocity of each frame; geometry, beamformed slice, cartesian image and array pattern."""

    def __init__(self, config: RadarConfig, dataset, processor, plotter,
                 **kwargs):
        super().__init__(**kwargs)
        self.config = config
        self.dataset = dataset
        self.processor = processor
        self.plotter = plotter

    def _vehicle_vel(self, idx: int) -> np.ndarray:
        if getattr(self.dataset, "vehicle_vel_enabled", False):
            vel = np.asarray(self.dataset.get_vehicle_vel_data(idx))
            return np.mean(np.atleast_2d(vel), axis=0)[:3]
        return _velocity_ned(self.dataset, idx)

    def compute_frame_panels(self, idx: int) -> dict:
        """Frame ``idx``'s ``velocity``, ``response`` (empty where the velocity gate fails), ``pattern`` (``None`` then) and ``lidar`` (``None`` without lidar).

        The processor returns its response, geometry and cartesian image on
        the host already.
        """
        adc = self.dataset.get_radar_adc_data(idx)
        vel = self._vehicle_vel(idx)
        resp = self.processor.process(adc, current_vel=vel)
        pattern = None
        if resp.size:
            pattern = self.processor.compute_synthetic_array_pattern(
                self.processor.array_geometry)
        lidar = None
        if getattr(self.dataset, "lidar_enabled", False):
            lidar = self.dataset.get_lidar_point_cloud_raw(idx)
        return {"velocity": vel, "response": resp, "pattern": pattern, "lidar": lidar}

    def generate_movie_frame(self, idx: int):
        import matplotlib.pyplot as plt

        panels = self.compute_frame_panels(idx)
        if panels["response"].size == 0:
            fig, ax = plt.subplots(figsize=(12, 8))
            ax.text(0.5, 0.5,
                    f"frame {idx}: velocity gate not satisfied\n"
                    f"vel={np.round(panels['velocity'], 3)}",
                    ha="center", va="center")
            ax.axis("off")
            return fig
        return self.plotter.plot_compilation(
            self.processor, panels["response"], pattern=panels["pattern"],
            lidar_points=panels["lidar"],
        )
