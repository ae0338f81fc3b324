"""DFT-as-matmul spectral stages (JAX: ``ops/mxu.py``).

The transforms are tiny (63 samples, 70 chirps, 64 angle bins), so each is a
matrix product with the window and the fftshift folded into a constant
factor matrix.  The JAX package keeps split re/im float32 planes because its
TPU runtime had no complex dtypes; here the data is ``complex64`` and a
factor pair ``(C, S)`` becomes the complex matrix ``M = C - jS``.

The factors are built exactly as the JAX package builds them — float64 numpy,
then one cast to float32 — so both packages hold the same bits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import dbs_pick as dbs_kernel
from mmwave_radar_processing_tpu_torch.ops.windows import hanning

Factors = Tuple[torch.Tensor, torch.Tensor]


def dft_factors(
    n_in: int,
    n_out: Optional[int] = None,
    *,
    shift: bool = False,
    window: Optional[np.ndarray] = None,
) -> Factors:
    """Real ``(C, S)`` factors of a zero-padded ``n_out``-point DFT of ``n_in`` inputs.

    ``X[k] = sum_j w[j] x[j] exp(-2j*pi*k*j/n_out)``, i.e. ``M = C - jS`` of
    shape ``(n_in, n_out)``.  ``shift`` puts the output bins in fftshift
    order; ``window`` folds a spectral window over the inputs into the matrix.
    Float32 CPU tensors, bit-equal to ``ops/mxu.dft_factors``.
    """
    n_out = n_out or n_in
    j = np.arange(n_in)[:, None]
    k = np.arange(n_out)[None, :]
    if shift:
        k = (k + n_out // 2) % n_out
    ang = 2 * np.pi * j * k / n_out
    c, s = np.cos(ang), np.sin(ang)
    if window is not None:
        c = c * window[:, None]
        s = s * window[:, None]
    return (torch.from_numpy(c.astype(np.float32)),
            torch.from_numpy(s.astype(np.float32)))


def zoom_dft_factors(
    f1: torch.Tensor, f2: torch.Tensor, *, n: int, m: int, fs: float,
    window: Optional[np.ndarray] = None,
) -> Factors:
    """Zoom DTFT factors with per-frame band edges (JAX: ``mxu.zoom_dft_factors_dynamic``).

    Frequencies ``f_k = f1 + k*(f2-f1)/m`` (scipy ``ZoomFFT``, endpoint
    excluded), angles ``2*pi*j*f_k/fs``.  ``f1``, ``f2``: float32 ``[...]``;
    returns float32 ``(C, S)`` of shape ``[..., n, m]``, built in float32 in
    the JAX package's order of operations.  ``window`` folds a window over
    the ``n`` inputs into the matrix.
    """
    jv = torch.arange(n, dtype=torch.float32, device=f1.device)[:, None]
    kv = torch.arange(m, dtype=torch.float32, device=f1.device)[None, :]
    f1, f2 = f1[..., None, None], f2[..., None, None]
    freqs = f1 + kv * (f2 - f1) / m
    ang = 2 * np.pi * jv * freqs / fs
    c, s = torch.cos(ang), torch.sin(ang)
    if window is not None:
        w = torch.as_tensor(np.asarray(window, np.float32), device=f1.device)[:, None]
        c, s = c * w, s * w
    return c, s


def to_matrix(factors: Factors) -> torch.Tensor:
    """``(C, S) -> C - jS`` as one ``complex64`` matrix (negation is exact)."""
    c, s = factors
    return torch.complex(c, -s)


def range_doppler_factors(ns: int, nc: int) -> Tuple[Factors, Factors]:
    """Windowed range DFT and windowed, fftshifted Doppler DFT factors."""
    return (
        dft_factors(ns, window=hanning(ns, np.float64)),
        dft_factors(nc, window=hanning(nc, np.float64), shift=True),
    )


def aoa_factors(n_antennas: int, num_angle_bins: int, shift: bool) -> Factors:
    """Zero-padded angle DFT: rectangular ``(n_antennas, num_angle_bins)``."""
    return dft_factors(n_antennas, num_angle_bins, shift=shift)


def aoa_union_layout(az_idx: Sequence[int], el_idx: Sequence[int]):
    """Channel-subset layout of the point-cloud pipeline.

    Returns ``(union_idx, az_pos, el_pos, needed)``: the sorted union of the
    two antenna subsets, each subset's positions within that union, and the
    channel tuple ``(0,) + union`` (channel 0 carries the CFAR map).  The same
    numpy arithmetic as ``ops/mxu.aoa_union_layout``.
    """
    az_idx = np.asarray(az_idx, int)
    el_idx = np.asarray(el_idx, int)
    union_idx = np.unique(np.concatenate([az_idx, el_idx])) if (
        az_idx.size or el_idx.size) else np.zeros(0, int)
    az_pos = np.searchsorted(union_idx, az_idx)
    el_pos = np.searchsorted(union_idx, el_idx)
    needed = (0,) + tuple(int(v) for v in union_idx)
    return union_idx, az_pos, el_pos, needed


#: float32 1/ln(10): ``jnp.log10`` is ``log(x) * (1/ln 10)``
_INV_LN10 = np.float32(0.4342944819032518)


def db20(x: torch.Tensor) -> torch.Tensor:
    """``20*log10(x)`` as the JAX package computes it: ``20 * (log(x) * (1/ln 10))`` in float32."""
    return 20.0 * (torch.log(x) * _INV_LN10)


def cabs(z: torch.Tensor) -> torch.Tensor:
    """``sqrt(re*re + im*im)`` — the JAX package's magnitude, not ``torch.abs``.

    ``torch.abs`` of a complex tensor is ``hypot``, which rounds differently;
    the CFAR decisions downstream compare this value against scaled
    neighbours, so the borderline cells depend on the exact formula.
    """
    re, im = z.real, z.imag
    return torch.sqrt(re * re + im * im)


def dbs_pick_reference(spec: torch.Tensor, weights: torch.Tensor,
                       bins: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`dbs_pick`: a gather of the ``A`` values at the bins, their weighted sum, :func:`cabs`.

    Forms ``[B, A, ns, D]``, the kept points' antenna values, and no cube.
    """
    b, a, ns, _ = spec.shape
    picked = torch.gather(spec, 3, bins[:, None, None, :].expand(b, a, ns, -1))
    return cabs((picked * weights[:, None, :]).sum(dim=1))


def dbs_pick(spec: torch.Tensor, weights: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """DBS's velocity-steered pick: ``[B, A, ns, L]``, ``[A, D]``, ``int64 [B, D]`` -> float32 ``[B, ns, D]``.

    ``out[b, r, d] = cabs(sum_a spec[b, a, r, bins[b, d]] * weights[a, d])``:
    with ``spec`` the range-Doppler spectrum of ``A`` antennas and
    ``weights`` the angle DFT's column of each output angle, the magnitude
    of the range-Doppler-angle cube at (range bin, the frame's Doppler bin,
    that angle), formed without the cube.  Dispatches on the device of
    ``spec``: a CPU tensor takes the plain version
    :func:`dbs_pick_reference`, any other the hand-written CUDA kernel
    (:mod:`.kernels.dbs_pick`), which writes only the kept magnitudes, or
    raises: it takes complex64 CUDA tensors alone (views are made
    contiguous first).  There is no fallback from one to the other.
    """
    if spec.device.type == "cpu":
        return dbs_pick_reference(spec, weights, bins)
    return dbs_kernel.dbs_pick(spec.contiguous(), weights.contiguous(), bins.contiguous())


def range_dft_channels(
    raw: torch.Tensor, channels, rng: torch.Tensor, *,
    num_rx: int, cfgs_per_loop: int,
) -> torch.Tensor:
    """Virtual-array channel selection fused with the windowed range DFT.

    TDM chirp order is ``chirp = loop*cfgs_per_loop + cfg`` and virtual
    channel ``v = cfg*num_rx + rx`` (``processors/virtual_array.py``), so
    channel ``v`` of the reformatted cube is ``raw[rx, :, loop*cpl + cfg]``:
    a strided view of the raw cube.  Only ``channels`` are gathered, never
    the full virtual cube.

    Args:
        raw: ``complex64 [..., rx, ns, loops*cfgs_per_loop]`` raw ADC cube.
        channels: virtual channel indices to produce (a sequence, or an
            int64 tensor on ``raw``'s device, which avoids a host copy).
        rng: ``complex64 (ns, n_range_out)`` range DFT matrix.

    Returns:
        ``complex64 [..., len(channels), n_range_out, loops]``, equal to the
        DFT along samples of ``reformat(raw)[..., channels, :, :]``.
    """
    *lead, rx, ns, nt = raw.shape
    loops = nt // cfgs_per_loop
    r5 = raw[..., :num_rx, :, :].reshape(*lead, num_rx, ns, loops,
                                         cfgs_per_loop)
    r5 = torch.movedim(r5, -1, -4)  # [..., cfg, rx, ns, loops] (a view)
    ch = torch.as_tensor(channels, dtype=torch.int64, device=raw.device)
    sel = r5[..., ch // num_rx, ch % num_rx, :, :]  # [..., A, ns, loops]
    return torch.matmul(rng.transpose(0, 1), sel)


def range_dft_input(
    raw: torch.Tensor, channels: torch.Tensor, rng: torch.Tensor, *,
    reformat_input: bool, num_rx: int, cfgs_per_loop: int,
) -> torch.Tensor:
    """Range DFT of ``channels`` of a pipeline's input planes.

    With ``reformat_input`` the input is a raw cube and the reformat is folded
    into the selection (:func:`range_dft_channels`); without, it is an
    already reformatted ``[B, virtual channels, ns, loops]`` cube and the
    channels are a plain gather.  ``channels`` is an int64 tensor on
    ``raw``'s device.
    """
    if reformat_input:
        return range_dft_channels(raw, channels, rng, num_rx=num_rx,
                                  cfgs_per_loop=cfgs_per_loop)
    return torch.matmul(rng.transpose(0, 1), raw[:, channels])


def rd_values(
    R: torch.Tensor, dop: torch.Tensor, r_idx: torch.Tensor,
    v_idx: torch.Tensor,
) -> torch.Tensor:
    """Per-detection range-Doppler values from the range-transformed cube.

    The JAX package selects range rows and Doppler factor columns with
    one-hot matmuls (``ops/mxu.rd_values_from_range_dft``) because gathers
    serialize on the TPU; here both are index gathers, and the remaining
    Doppler contraction runs in float32.

    Args:
        R: ``complex64 [B, A, W, L]`` range-DFT'd cube.
        dop: ``complex64 (L, V)`` Doppler DFT matrix.
        r_idx, v_idx: ``int64 [B, K]`` range and Doppler bin indices.

    Returns:
        ``complex64 [B, A, K]``: ``sum_l R[b, a, r_k, l] * dop[l, v_k]``.
    """
    b, a, _, l = R.shape
    k = r_idx.shape[-1]
    rows = torch.gather(R, 2, r_idx[:, None, :, None].expand(b, a, k, l))
    cols = dop.transpose(0, 1)[v_idx]  # [B, K, L]
    return torch.einsum("bakl,bkl->bak", rows, cols)


def aoa_peak_angles(
    vals: torch.Tensor, pos: torch.Tensor, aoa: torch.Tensor,
    angle_bins: torch.Tensor,
) -> torch.Tensor:
    """Per-detection angle: zero-padded angle DFT of ``vals[pos]``, argmax bin.

    Args:
        vals: ``complex64 [B, U, K]`` values on the antenna union.
        pos: ``int64 (A,)`` this subset's positions within the union.
        aoa: ``complex64 (A, n_bins)`` angle DFT matrix.
        angle_bins: ``float32 (n_bins,)`` bin angles in radians.

    Returns:
        ``float32 [B, K]``.  Ties in ``|spec|^2`` go to the first bin, as
        ``jnp.argmax`` does.
    """
    snap = vals[:, pos].transpose(1, 2)  # [B, K, A]
    spec = torch.matmul(snap, aoa)
    power = spec.real * spec.real + spec.imag * spec.imag
    return angle_bins[torch.argmax(power, dim=-1)]
