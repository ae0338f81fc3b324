"""CPSL-dataset-compatible loader of the port (JAX: ``data/cpsl_dataset.py``, numpy only).

The reference consumes recordings through a ``CpslDS`` class from the
``cpsl_datasets`` submodule (not vendored in the snapshot); its API surface is
reconstructed from call sites (SURVEY.md §2.11, e.g.
``visualization/models/dataset_model.py:67-119``,
``plotting/movies_mmWave_data.py:57-76``).  This implementation reads
folder-per-modality NPY layouts:

    dataset_path/
      radar_0_adc/   frame_*.npy   complex [rx, sample, chirp]
      vehicle_odom/  frame_*.npy   (M, >=11), cols 8:11 = vx,vy,vz
      vehicle_vel/   frame_*.npy
      lidar/         frame_*.npy   (N, >=3) point clouds
      camera/        frame_*.npy / *.png images
      ...

Files are index-aligned by sorted name.  A writer is provided so simulated
scenes can be materialized in the same layout.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


class CpslDS:
    """Folder-of-NPY dataset reader with the reference ``CpslDS`` API."""

    def __init__(
        self,
        dataset_path: str,
        radar_adc_folder: str = "radar_0_adc",
        radar_pc_folder: str = "",
        lidar_folder: str = "lidar",
        camera_folder: str = "camera",
        hand_tracking_folder: str = "hand_tracking",
        imu_orientation_folder: str = "imu_orientation",
        imu_full_folder: str = "imu_data",
        vehicle_vel_folder: str = "vehicle_vel",
        vehicle_odom_folder: str = "vehicle_odom",
        **kwargs,
    ):
        self.dataset_path = dataset_path
        self._files = {}
        for key, folder in [
            ("radar_adc", radar_adc_folder),
            ("radar_pc", radar_pc_folder),
            ("lidar", lidar_folder),
            ("camera", camera_folder),
            ("hand_tracking", hand_tracking_folder),
            ("imu_orientation", imu_orientation_folder),
            ("imu_full", imu_full_folder),
            ("vehicle_vel", vehicle_vel_folder),
            ("vehicle_odom", vehicle_odom_folder),
        ]:
            self._files[key] = self._list(folder)

        self.radar_enabled = bool(self._files["radar_adc"])
        self.radar_pc_enabled = bool(self._files["radar_pc"])
        self.lidar_enabled = bool(self._files["lidar"])
        self.camera_enabled = bool(self._files["camera"])
        self.hand_tracking_enabled = bool(self._files["hand_tracking"])
        self.imu_orientation_enabled = bool(self._files["imu_orientation"])
        self.imu_full_enabled = bool(self._files["imu_full"])
        self.vehicle_vel_enabled = bool(self._files["vehicle_vel"])
        self.vehicle_odom_enabled = bool(self._files["vehicle_odom"])
        self.num_frames = len(self._files["radar_adc"]) or len(
            self._files["radar_pc"]
        )

    def _list(self, folder: str) -> List[str]:
        if not folder:
            return []
        path = os.path.join(self.dataset_path, folder)
        if not os.path.isdir(path):
            return []
        return sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.endswith((".npy", ".npz", ".png", ".jpg"))
        )

    # ------------------------------------------------------------------ #
    def get_radar_adc_data(self, idx: int) -> np.ndarray:
        """Complex ADC cube ``[rx, sample, chirp]`` for frame ``idx``."""
        return np.load(self._files["radar_adc"][idx])

    def get_radar_adc_paths(self) -> List[str]:
        """The ADC frames' files in frame order (for a bulk loader)."""
        return list(self._files["radar_adc"])

    def get_radar_point_cloud(self, idx: int) -> np.ndarray:
        """Pre-generated radar point cloud ``(N, >=4)`` for frame ``idx``.

        The reference reads recorded point clouds through a ``radar_pc_folder``
        (call site: ``notebooks/hermes_testing_vel_estimation_outward_points
        .ipynb``, ``radar_pc_folder="front_radar_pc"``).
        """
        assert self.radar_pc_enabled, "radar point clouds not in dataset"
        return np.load(self._files["radar_pc"][idx])

    def get_vehicle_odom_data(self, idx: int) -> np.ndarray:
        """Odometry rows ``(M, >=11)``; columns 8:11 are vx,vy,vz ground truth."""
        return np.load(self._files["vehicle_odom"][idx])

    def get_radar_data(self, idx: int) -> np.ndarray:
        """Radar frame for ``idx`` — alias of :meth:`get_radar_adc_data`.

        The reference consumes both ADC cubes and pre-generated point clouds
        through this name, depending on which folder the dataset was pointed
        at (call sites: ``plotting/movies_synthetic_array_data.py:31``,
        ``plotting/movies_odometry.py:54,84``,
        ``notebooks/view_radar_data_hand_tracking.ipynb``).
        """
        if self.radar_enabled:
            return self.get_radar_adc_data(idx)
        return self.get_radar_point_cloud(idx)

    def get_vehicle_vel_data(self, idx: int) -> np.ndarray:
        return np.load(self._files["vehicle_vel"][idx])

    def get_hand_tracking_data(self, idx: int) -> np.ndarray:
        """Hand-joint rows ``(J, 3)`` for frame ``idx`` (ref hand notebook)."""
        assert self.hand_tracking_enabled, "hand tracking not in dataset"
        return np.load(self._files["hand_tracking"][idx])

    def get_imu_orientation_data(self, idx: int) -> np.ndarray:
        """Orientation quaternion/euler rows for frame ``idx``."""
        assert self.imu_orientation_enabled, "imu orientation not in dataset"
        return np.load(self._files["imu_orientation"][idx])

    def get_imu_full_data(self, idx: int) -> np.ndarray:
        """Full IMU rows (gyro+accel) for frame ``idx``."""
        assert self.imu_full_enabled, "full imu data not in dataset"
        return np.load(self._files["imu_full"][idx])

    def get_lidar_point_cloud_raw(self, idx: int) -> np.ndarray:
        return np.load(self._files["lidar"][idx])

    def get_camera_frame(self, idx: int) -> np.ndarray:
        assert self.camera_enabled, "camera data not available in dataset"
        path = self._files["camera"][idx]
        if path.endswith(".npy"):
            return np.load(path)
        import imageio.v2 as imageio

        return imageio.imread(path)


def _write_frames(dataset_path: str, folder: str, frames) -> None:
    out_dir = os.path.join(dataset_path, folder)
    os.makedirs(out_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        np.save(os.path.join(out_dir, f"frame_{i:05d}.npy"), frame)


def write_dataset(
    dataset_path: str,
    adc_frames: Optional[np.ndarray] = None,
    odom: Optional[np.ndarray] = None,
    vel: Optional[np.ndarray] = None,
    hand_tracking: Optional[np.ndarray] = None,
    imu_orientation: Optional[np.ndarray] = None,
    imu_full: Optional[np.ndarray] = None,
    radar_pc: Optional[list] = None,
    radar_adc_folder: str = "radar_0_adc",
    radar_pc_folder: str = "radar_0_pc",
    vehicle_odom_folder: str = "vehicle_odom",
    vehicle_vel_folder: str = "vehicle_vel",
    hand_tracking_folder: str = "hand_tracking",
    imu_orientation_folder: str = "imu_orientation",
    imu_full_folder: str = "imu_data",
) -> None:
    """Materialize frames (and optional ground truth) in the CpslDS layout.

    Args:
        adc_frames: ``[frames, rx, sample, chirp]`` complex.
        odom: optional ``[frames, M, >=11]`` odometry (cols 8:11 = velocity).
        vel: optional ``[frames, M, >=3]`` velocity rows.
        hand_tracking: optional ``[frames, J, 3]`` hand-joint positions.
        imu_orientation: optional ``[frames, 4]`` orientation quaternions.
        imu_full: optional ``[frames, 6]`` gyro+accel rows.
        radar_pc: optional list of per-frame ``(N, >=4)`` point clouds.
    """
    if adc_frames is not None:
        _write_frames(dataset_path, radar_adc_folder, adc_frames)
    if radar_pc is not None:
        _write_frames(dataset_path, radar_pc_folder, radar_pc)
    for data, folder in [
        (odom, vehicle_odom_folder),
        (vel, vehicle_vel_folder),
        (hand_tracking, hand_tracking_folder),
        (imu_orientation, imu_orientation_folder),
        (imu_full, imu_full_folder),
    ]:
        if data is not None:
            _write_frames(dataset_path, folder, data)


def make_odom_rows(velocity: np.ndarray, rows: int = 5) -> np.ndarray:
    """Odometry block whose columns 8:11 hold ``velocity`` (reference layout)."""
    out = np.zeros((rows, 11))
    out[:, 8:11] = np.asarray(velocity)[None, :]
    return out
