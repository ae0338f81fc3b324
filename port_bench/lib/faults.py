"""Faults planted under the timed path, for the tests that show ``correct`` can come out false.

Each wraps a frame-batched pipeline (``(raw_re, raw_im, *args) -> outputs``,
the outputs a ``PointCloudBatch`` or a ``(PointCloudBatch, VelocityBatch)``
pair) and breaks it where its answers are produced:

- ``unchanged``: every call returns its outputs as zeros, as a step that
  leaves its state as it was;
- ``half_batch``: only the first half of each batch is computed, the rest
  of the outputs are zeros;
- ``altered``: each frame's first point is moved by one Doppler bin.
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered")


def _leaves(out, fn):
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return type(out)(_leaves(o, fn) for o in out)
    return type(out)(*(fn(t) for t in out))


def wrap(pipeline, fault: str, vel_res: float):
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}, expected one of {FAULTS}")

    def call(raw_re, raw_im, *args, **kwargs):
        b = raw_re.shape[0]
        if fault == "half_batch":
            h = b // 2
            out = pipeline(raw_re[:h], raw_im[:h], *(a[:h] for a in args),
                           **{k: v[:h] if torch.is_tensor(v) else v for k, v in kwargs.items()})
            return _leaves(out, lambda t: torch.cat([t, torch.zeros_like(t[:b - h])]))
        out = pipeline(raw_re, raw_im, *args, **kwargs)
        if fault == "unchanged":
            return _leaves(out, torch.zeros_like)
        cloud = out[0] if not hasattr(out, "_fields") else out
        points = cloud.points.clone()
        points[:, 0, 3] += vel_res
        moved = cloud._replace(points=points)
        return moved if cloud is out else (moved, *out[1:])

    return call
