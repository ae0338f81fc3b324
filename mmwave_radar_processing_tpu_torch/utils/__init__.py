"""Support utilities of the port.

- ``verify``     — seeded input frames, the bench pipelines, their outputs
                   under the JAX package's names, ``compare_outputs`` and
                   ``run_verify`` against a committed JAX oracle.
- ``roofline``   — analytic FLOP and HBM-byte models of the bench metrics
                   and the H100's peaks.
- ``logger``     — the package's stdout logger (JAX: ``utils/logger.py``).
- ``env``        — the ``.env`` directory-root convention (JAX: ``utils/env.py``).
- ``rotations``  — 2D rotations (JAX: ``utils/rotations.py``; numpy).
- ``profiling``  — ``StageTimer``, ``fence``, ``trace``, ``annotate``; the
                   set-up records ``SETUP`` (``mmw.setup.*``).
- ``checkpoint`` — processor states to and from ``.npz``, in the JAX package's format.
"""

from mmwave_radar_processing_tpu_torch.utils import rotations
from mmwave_radar_processing_tpu_torch.utils.logger import get_logger, setup_logger

__all__ = ["rotations", "get_logger", "setup_logger"]
