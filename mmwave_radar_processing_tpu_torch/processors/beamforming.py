"""Capon / Bartlett range-azimuth heatmap processors (JAX: ``processors/beamforming.py``).

Per-frame objects over one virtual cube ``[n_virtual, ns, loops]``: a
windowed range DFT of the selected antennas, then per range bin the
covariance of its chirp snapshots and the Bartlett or Capon spectrum on the
reference ``arcsin(delta_phi/pi)`` angle grid.

In the JAX package the Capon processor runs XLA and only the Bartlett one
reaches a TPU kernel.  Here the device decides: on a GPU both run their CUDA
kernel (``ops.beamform``), on the CPU both run the plain versions.  The range
DFT's ``[A, ns, K]`` is the kernels' ``[1, A, W, K]``, and the
azimuth-elevation heatmap's one range gate is ``[1, A, 1, K]``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops import beamform as bf, dft
from mmwave_radar_processing_tpu_torch.ops.windows import hanning
from mmwave_radar_processing_tpu_torch.processors.base import (
    Processor,
    as_complex64,
    resolve_device,
)

# Flagship 6843 ODS antenna subsets (hardcoded in the reference consumers)
ODS_AZ_IDXS = (0, 3, 4, 7)
ODS_EL_IDXS = (9, 8, 5, 4)


def l_array_positions(
    az_idxs: Sequence[int], el_idxs: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Joint (y, z) element positions of two crossed half-wavelength ULAs.

    ``az_idxs`` is a ULA along azimuth and ``el_idxs`` one along elevation.
    When they share an element, the azimuth row sits at that element's
    elevation coordinate and the elevation column at its azimuth coordinate:
    an L-shaped array (for the ODS sets the shared element 4 puts the row at
    ``z = 3`` and the column at ``y = 2``).

    Returns:
        ``(antenna_idxs, positions)``: unique element indices (the azimuth
        subset first, then the unshared elevation elements) and float32
        ``(A, 2)`` positions in half-wavelength units ``(y, z)``.
    """
    az = list(az_idxs)
    el = list(el_idxs)
    shared = [e for e in el if e in az]
    y_col = float(az.index(shared[0])) if shared else 0.0
    z_row = float(el.index(shared[0])) if shared else 0.0

    idxs, pos = [], []
    for i, a in enumerate(az):
        idxs.append(a)
        pos.append((float(i), z_row))
    for i, e in enumerate(el):
        if e in az:
            continue
        idxs.append(e)
        pos.append((y_col, float(i)))
    return np.asarray(idxs, int), np.asarray(pos, np.float32)


class _CovarianceBeamformerProcessor(Processor):
    """Shared machinery: snapshots, steering, grids and the view's payload."""

    #: subclasses set the spectrum estimator
    _method = "bartlett"

    def __init__(
        self,
        config: RadarConfig,
        antenna_idxs: Optional[Sequence[int]] = None,
        num_angle_bins: int = 64,
        diagonal_loading: float = 1e-2,
        *,
        device,
        **kwargs,
    ):
        super().__init__(config)
        if antenna_idxs is None:
            antenna_idxs = range(config.num_virtual_antennas
                                 if config.virtual_antennas_enabled
                                 else config.num_rx_antennas)
        self.antenna_idxs = np.asarray(list(antenna_idxs), int)
        self.num_angle_bins = num_angle_bins
        self.diagonal_loading = diagonal_loading
        self.device = resolve_device(device)

        ns = self.config.num_adc_samples
        self.range_bins = grids.range_bins(self.config, variant="eps")
        self.phase_shifts = grids.phase_shift_bins(num_angle_bins)
        self.angle_bins = grids.angle_bins(num_angle_bins)
        # the cartesian mesh of RangeAngleProcessor, so the range-angle view
        # renders these maps unchanged
        self.thetas, self.rhos, self.x_s, self.y_s = grids.polar_mesh(
            self.range_bins, self.angle_bins)
        # float32 window, as the JAX processors build it
        self._rng_dft = dft.to_matrix(dft.dft_factors(
            ns, window=hanning(ns))).to(self.device)
        self._steering = bf.steering_ula(
            self.phase_shifts, len(self.antenna_idxs)).to(self.device)
        self._idx = torch.as_tensor(self.antenna_idxs, device=self.device)

    # ------------------------------------------------------------------ #
    def _as_complex(self, adc_cube) -> torch.Tensor:
        """A complex cube (tensor or numpy) as complex64 on the processor's device."""
        return as_complex64(adc_cube, self.device)

    def _range_dft(self, cube: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Windowed range DFT of the antennas ``idx``: ``[A, ns, K]``."""
        return torch.matmul(self._rng_dft.transpose(0, 1), cube[idx])

    def _power(self, x: torch.Tensor, steering: torch.Tensor) -> torch.Tensor:
        """``[1, A, W, K]`` -> ``[1, W, M]`` with this processor's estimator."""
        if self._method == "bartlett":
            return bf.bartlett_power(x, steering)
        return bf.capon_power(x, steering, loading=self.diagonal_loading)

    def snapshots(self, cube) -> torch.Tensor:
        """``[rx, ns, nc]`` complex cube -> per-range-bin snapshots ``[ns, A, K]``."""
        return self._range_dft(self._as_complex(cube), self._idx).movedim(0, 1)

    def heatmap(self, cube) -> torch.Tensor:
        """``[range_bins, angle_bins]`` float32 power map, on the processor's device."""
        rng = self._range_dft(self._as_complex(cube), self._idx)
        return self._power(rng[None], self._steering)[0]

    def azimuth_elevation_heatmap(
        self,
        adc_cube,
        range_idx: int,
        az_idxs: Sequence[int] = ODS_AZ_IDXS,
        el_idxs: Sequence[int] = ODS_EL_IDXS,
        num_az_bins: int = 64,
        num_el_bins: int = 32,
        antenna_idxs: Optional[Sequence[int]] = None,
        positions: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Joint (azimuth, elevation) spectrum at one range gate.

        Pass ``antenna_idxs`` and ``positions`` (``(A, 2)`` in half-wavelength
        ``(y, z)`` units) for a full-aperture planar beamform; otherwise the
        L-array of :func:`l_array_positions` is built from the az/el subsets.
        Angle grids are the reference ``arcsin``-convention bins.

        Returns:
            ``(num_az_bins, num_el_bins)`` numpy float32 power map.
        """
        cube = self._as_complex(adc_cube)
        if positions is not None:
            if antenna_idxs is None:
                antenna_idxs = range(cube.shape[0])
            idxs = np.asarray(list(antenna_idxs), int)
            pos = np.asarray(positions, np.float32)
        else:
            idxs, pos = l_array_positions(az_idxs, el_idxs)
        steering = bf.steering_planar(pos, grids.angle_bins(num_az_bins),
                                      grids.angle_bins(num_el_bins))
        rng = self._range_dft(cube, torch.as_tensor(idxs, device=self.device))
        gate = rng[:, range_idx][None, :, None, :].contiguous()  # [1, A, 1, K]
        power = self._power(gate, steering.to(self.device))
        return power.cpu().numpy().reshape(num_az_bins, num_el_bins)

    def process(self, adc_cube, **kwargs) -> torch.Tensor:
        """Reference-style API: complex cube -> power heatmap."""
        return self.heatmap(adc_cube)


class BartlettBeamformerProcessor(_CovarianceBeamformerProcessor):
    """Conventional (Bartlett) beamformer range-azimuth heatmap."""

    _method = "bartlett"


class CaponBeamformerProcessor(_CovarianceBeamformerProcessor):
    """Capon/MVDR super-resolution range-azimuth heatmap."""

    _method = "capon"
