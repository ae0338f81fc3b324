"""Support utilities of the port.

- ``verify``     — seeded input frames and ``compare_outputs``.
- ``logger``     — the package's stdout logger (JAX: ``utils/logger.py``).
- ``env``        — the ``.env`` directory-root convention (JAX: ``utils/env.py``).
- ``rotations``  — 2D rotations (JAX: ``utils/rotations.py``; numpy).
- ``profiling``  — ``StageTimer``, ``fence``, ``trace``, ``annotate``.
- ``checkpoint`` — processor states to and from ``.npz``, in the JAX package's format.
"""
