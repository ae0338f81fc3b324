"""Overlap-save sharded spectral zoom: demodulate, FIR, decimate, zoom DFT (JAX: ``parallel/overlap_save.py``).

When a long sample axis is split over ranks, the chirp-z zoom cannot run
locally (its chirp kernel spans the whole axis), but the FIR form of the
same zoom (:mod:`..ops.zoom_fir`) is local apart from ``num_taps - 1``
boundary samples.  Each rank:

    1. demodulates its shard with the factors of the global sample indices
       (a host table, sliced by the rank's coordinate),
    2. receives its left neighbour's last ``num_taps - 1`` demodulated
       samples (the overlap-save halo; the first rank gets zeros, the
       unsharded op's causal zero padding),
    3. runs the same valid-mode tap loop as the unsharded op,
    4. decimates locally (a shard's length is a multiple of ``decim``, so
       the global stride stays aligned),
    5. scatters its decimated chunk into its slot of a zero signal of
       ``n / decim`` samples, takes one all-reduce by sum over the axis
       (adding zeros is exact), and applies the zoom DFT, replicated.

Steps 1-4 execute the same float32 operations in the same order as
:func:`..ops.zoom_fir.zoom_fft_fir`, so the result is bit-equal to it on
the same device.  The halo costs ``(num_taps - 1) * 8`` bytes a signal row
and rank, where a gathered chirp-z would move the whole axis.
"""

from __future__ import annotations

import torch

from mmwave_radar_processing_tpu_torch.ops import zoom_fir
from mmwave_radar_processing_tpu_torch.parallel.collectives import from_left, psum
from mmwave_radar_processing_tpu_torch.parallel.mesh import axis_index, axis_size


def _left_halo(x_local: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Prepend the left neighbour's last ``halo`` samples (zeros on the first rank).

    The causal FIR only looks back, so overlap-save needs a left halo only,
    half the traffic of the CFAR's two-sided exchange.
    """
    if x_local.shape[-1] < halo:
        raise ValueError(
            f"overlap-save needs samples_per_shard >= num_taps - 1 (= {halo})"
            f" on the sharded axis, got {x_local.shape[-1]}; use fewer shards"
            f" or a shorter filter"
        )
    return torch.cat([from_left(x_local, halo, group, dim=-1), x_local], dim=-1)


def build_sharded_zoom_fir(mesh, *, n: int, f_center: float, fs: float, decim: int,
                           num_taps: int, m: int, f1: float, f2: float, axis: str = "model"):
    """Build ``fn(x_local) -> spectrum`` with the sample axis split over ``axis``.

    ``x_local``: complex64 ``[..., n / axis_size]``, this rank's samples;
    leading axes are batch.  Returns the complex64 ``[..., m]`` zoom
    spectrum, the same on every rank of the axis, bit-equal to
    ``ops.zoom_fir.zoom_fft_fir`` with the same parameters.
    """
    n_shards = axis_size(mesh, axis)
    if n % n_shards != 0:
        raise ValueError(f"n={n} must divide over {n_shards} shards")
    local_n = n // n_shards
    if local_n % decim != 0:
        raise ValueError(
            f"samples_per_shard={local_n} must be a multiple of decim={decim}"
            f" so local decimation stays globally stride-aligned"
        )
    halo = num_taps - 1
    group = mesh.get_group(axis)
    idx = axis_index(mesh, axis)
    start, local_n2 = idx * local_n, local_n // decim
    consts = {}

    def local(x_local: torch.Tensor) -> torch.Tensor:
        if x_local.device not in consts:
            taps, (dr, di), factors = zoom_fir.zoom_setup(
                n, f_center=f_center, fs=fs, decim=decim, num_taps=num_taps, m=m,
                f1=f1, f2=f2, device=x_local.device)
            consts[x_local.device] = (taps, dr[start:start + local_n],
                                      di[start:start + local_n], factors)
        taps, dr, di, factors = consts[x_local.device]
        d_re, d_im = zoom_fir.demodulate(x_local.real, x_local.imag, dr, di)
        planes = torch.stack([d_re, d_im])
        filtered = zoom_fir.fir_valid(_left_halo(planes, halo, group), taps)
        slot = planes.new_zeros(planes.shape[:-1] + (n // decim,))
        slot[..., idx * local_n2:(idx + 1) * local_n2] = filtered[..., ::decim]
        full = psum(slot, group)
        return zoom_fir.dft_apply(full[0], full[1], factors)

    return local
