"""2D rotation utilities of the port (JAX: ``utils/rotations.py``).

Batched formulations: every function accepts stacked rotations/translations and
runs as a single einsum, replacing the reference's per-rotation list
comprehensions (:82-120).
"""

from __future__ import annotations

import numpy as np


def get_rot_matrix(rot_angle_rad: float) -> np.ndarray:
    """2x2 rotation matrix for ``rot_angle_rad`` (counter-clockwise)."""
    c, s = np.cos(rot_angle_rad), np.sin(rot_angle_rad)
    return np.array([[c, -s], [s, c]])


def get_rot_matrices(rot_angles_rad: np.ndarray) -> np.ndarray:
    """(N, 2, 2) stack of rotation matrices."""
    c, s = np.cos(rot_angles_rad), np.sin(rot_angles_rad)
    return np.stack(
        [np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2
    )


def get_angle_from_rot_matrix(rot_matrix: np.ndarray) -> float:
    """Rotation angle recovered from a 2x2 rotation matrix."""
    return np.arctan2(rot_matrix[1, 0], rot_matrix[0, 0])


def apply_rot_trans(points: np.ndarray, rot_angle_rad, trans) -> np.ndarray:
    """``(points @ R.T) + trans`` for an (N, 2) point set."""
    return points @ get_rot_matrix(rot_angle_rad).T + np.asarray(trans)


def apply_multiple_rot_trans(points, rot_angles_rad, translations) -> np.ndarray:
    """N transformed copies of an (M, 2) point set -> (N, M, 2)."""
    r = get_rot_matrices(np.asarray(rot_angles_rad))
    return np.einsum("mj,nkj->nmk", points, r) + np.asarray(translations)[:, None, :]


def apply_unique_rot_trans_to_multiple_points(
    points, rot_angles_rad, translations
) -> np.ndarray:
    """The n-th rotation/translation applied to the n-th point -> (N, 1, 2)."""
    points = np.asarray(points)
    rot_angles_rad = np.asarray(rot_angles_rad)
    translations = np.asarray(translations)
    assert points.shape[0] == rot_angles_rad.shape[0] == translations.shape[0], (
        "all inputs must have N rows"
    )
    r = get_rot_matrices(rot_angles_rad)
    out = np.einsum("nj,nkj->nk", points, r) + translations
    return out[:, None, :]


def wrap_heading(heading_rad):
    """Wrap a heading to [-pi, pi]."""
    return (heading_rad + np.pi) % (2 * np.pi) - np.pi
