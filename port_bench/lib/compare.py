"""The numbers that decide ``correct``: the program's outputs against the plain reference's.

Point clouds are compared as sets of detected cells per frame.  A cell is
the ``(range bin, Doppler bin)`` of a point, read back from the point itself
(its range is ``|xyz|``, its fourth coordinate the velocity), so the
comparison needs nothing from the program but its output.

- ``det_mismatch``: over the sampled frames, the cells found by one side
  only, over the cells found by either.
- ``angle_mismatch``: of the cells both found, the share whose ``xyz``
  differs by more than 1 mm, i.e. whose azimuth or elevation bin differs.
- ``velocity_mismatch``: the share of sampled frames whose ego-velocity
  ``(vy az, vy el, vx)`` differs from the reference's by more than 1 mm/s in
  any component, or, where the timed path hands out its RANSAC fits, whose
  R^2 or inlier fraction of either fit differs by more than 1e-3.  The
  estimate is a fit over discrete peak picks, so a frame either agrees to
  rounding or differs by a pick.

Each is held to a limit of the cell's own (``limits`` in its workload file):
a run is correct when no number exceeds its limit.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np

ANGLE_TOL_M = 1e-3
VELOCITY_TOL_M_S = 1e-3
FIT_TOL = 1e-3


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


def _cells(points: np.ndarray, valid: np.ndarray, range_res: float, vel0: float,
           vel_res: float) -> List[Dict[tuple, np.ndarray]]:
    """Per frame ``{(range bin, Doppler bin): xyz}`` of the valid points."""
    out = []
    for pts, ok in zip(points, valid.astype(bool)):
        p = pts[ok].astype(np.float64)
        r = np.rint(np.linalg.norm(p[:, :3], axis=1) / range_res).astype(np.int64)
        d = np.rint((p[:, 3] - vel0) / vel_res).astype(np.int64)
        out.append({(int(a), int(b)): xyz for a, b, xyz in zip(r, d, p[:, :3])})
    return out


def cloud_numbers(points, valid, ref_points, ref_valid, *, range_res: float, vel_max: float,
                  vel_res: float) -> Dict[str, float]:
    """``det_mismatch`` and ``angle_mismatch`` of ``[F, K, 4]`` points with ``[F, K]`` valid flags."""
    mine = _cells(points, valid, range_res, -vel_max, vel_res)
    ref = _cells(ref_points, ref_valid, range_res, -vel_max, vel_res)
    only, union, common, moved = 0, 0, 0, 0
    for a, b in zip(mine, ref):
        ka, kb = set(a), set(b)
        only += len(ka ^ kb)
        union += len(ka | kb)
        for key in ka & kb:
            common += 1
            moved += int(np.max(np.abs(a[key] - b[key])) > ANGLE_TOL_M)
    return {"det_mismatch": only / union if union else 0.0,
            "angle_mismatch": moved / common if common else 0.0}


def _apart(a, b, tol: float) -> np.ndarray:
    """Which rows of ``[F, n]`` ``a`` and ``b`` differ by more than ``tol`` anywhere (NaN differs)."""
    gap = np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)), axis=1)
    return ~(gap <= tol)


def velocity_numbers(velocity, ref_velocity, fit=None, ref_fit=None) -> Dict[str, float]:
    """``velocity_mismatch`` of ``[F, 3]`` estimates and, where given, ``[F, 4]`` fits."""
    apart = _apart(velocity, ref_velocity, VELOCITY_TOL_M_S)
    if fit is not None:
        apart |= _apart(fit, ref_fit, FIT_TOL)
    return {"velocity_mismatch": float(np.mean(apart))}


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """Every number beside its limit; a number without a limit is an error of the cell's file."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return [Check(name, float(numbers[name]), float(limits[name])) for name in sorted(numbers)]
