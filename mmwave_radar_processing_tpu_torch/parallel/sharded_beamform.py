"""Beamforming with the aperture or the snapshots split over ranks (JAX: ``parallel/sharded_beamform.py``).

- :func:`build_sharded_beamformer`: synthetic-aperture beamforming with the
  element axis split.  Each rank forms the partial beam sum over its
  elements (one complex matmul), one all-reduce of the ``[ns, A]`` partial
  sums over the axis gives the full response, and the range FFT follows,
  replicated.  The traffic is independent of the aperture's length.
- :func:`build_snapshot_sharded_capon`: Capon or Bartlett spectra with the
  snapshot (chirp) axis split.  ``R = X X^H / K`` is a sum over snapshots,
  so each rank forms the partial covariance of its snapshots, one
  ``[N, A, A]`` all-reduce assembles ``R``, and the small solve and the
  spectrum run replicated (``ops.beamform.capon_from_covariance``,
  ``bartlett_from_covariance``).

The element-sharded beamformer forms its phases with
``processors.synthetic_array.steering_phases``, which on the GPU is a
hand-written kernel (no Pallas kernel's counterpart); the snapshot-sharded
Capon launches none: the JAX package's forms reach no Pallas kernel.  The
sums are taken in another order than the dense form's, so the results are
close to it, not bit-equal.  The data is
``complex64`` throughout.
"""

from __future__ import annotations

import torch

from mmwave_radar_processing_tpu_torch.ops import beamform as bf
from mmwave_radar_processing_tpu_torch.parallel.collectives import psum
from mmwave_radar_processing_tpu_torch.parallel.mesh import axis_size
from mmwave_radar_processing_tpu_torch.processors.synthetic_array import steering_phases


def build_sharded_beamformer(mesh, *, lambda_m: float, axis: str = "model",
                             split_complex: bool = False):
    """Build ``fn(data, positions, steering, range_window, element_window) -> response``.

    ``data`` complex64 ``[ns, E_local]``, ``positions`` float32
    ``[3, E_local]`` and ``element_window`` ``[E_local]`` are this rank's
    elements; ``steering`` ``[A, 3]`` and ``range_window`` ``[ns]`` are
    whole.  The response, complex64 ``[ns, A]``, is the same on every rank
    of the axis.

    ``split_complex=True`` (float32 planes and a DFT matmul for runtimes
    without complex dtypes) is a TPU workaround, not ported: it raises.
    """
    if split_complex:
        raise ValueError("split_complex=True is a TPU workaround and is not ported: "
                         "pass complex64 data")
    group = mesh.get_group(axis)

    def local(data, positions, steering, range_window, element_window):
        phases = steering_phases(steering, positions, lambda_m)  # [A, E_local]
        partial = (data * element_window[None, :]) @ phases.transpose(-1, -2)
        beamformed = psum(partial, group)
        return torch.fft.fft(beamformed * range_window[:, None], dim=0)

    return local


def build_snapshot_sharded_capon(mesh, *, loading: float = 1e-2, method: str = "capon",
                                 axis: str = "model"):
    """Build ``fn(x_local, steering) -> power`` with the snapshot axis split over ``axis``.

    ``x_local``: complex64 ``[N, A, K_local]``, this rank's snapshots;
    ``steering``: complex64 ``(A, M)``.  Returns float32 ``[N, M]``, the
    same on every rank of the axis, close to ``capon_from_covariance`` (or
    ``bartlett_from_covariance``) of the whole covariance.
    """
    if method not in ("capon", "bartlett"):
        raise ValueError(f"unknown method {method!r}")
    group = mesh.get_group(axis)
    n_shards = axis_size(mesh, axis)

    def local(x_local, steering):
        k_total = x_local.shape[-1] * n_shards
        r = psum(torch.matmul(x_local, x_local.mH) / k_total, group)
        if method == "bartlett":
            return bf.bartlett_from_covariance(r, steering)
        return bf.capon_from_covariance(r, steering, loading=loading)

    return local
