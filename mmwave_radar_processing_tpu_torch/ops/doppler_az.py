"""Doppler-azimuth responses of antenna sub-arrays (JAX: ``ops/pallas/doppler_az.py``).

For each frame ``b``, sub-array ``s``, angle bin ``a`` and velocity bin ``v``:

    out[b,s,a,v] = sum_w wgt[b,w] * | sum_r F[a, s*n_rx+r] * u[b, set_idx[s][r], w*nv+v] |

a zero-padded angle DFT of each sub-array of the chirp-DFT'd spectrum, its
magnitude, and a weighted sum over the range rows of the altitude window.
``F = fct - j*fst`` (the ``M = C - jS`` convention of ``ops/dft.py``), so
``re' = fc*re + fs*im`` and ``im' = fc*im - fs*re``.

:func:`set_responses` dispatches on the device only: a CPU tensor takes the
plain version :func:`set_responses_reference`, a CUDA tensor the hand-written
kernel (:mod:`.kernels.doppler_az`) or raises.  There is no fallback from one
to the other.  The plain version follows the Pallas kernel's order of
operations, each product and sum rounded on its own; the kernel does the same,
so on the card the two agree bit for bit.
"""

from __future__ import annotations

import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import doppler_az as kernel


def _check(u_re, u_im, wgt, fct, fst, set_idx, nv):
    """Shapes of one call; returns ``(n_sets, n_rx)``."""
    n_sets, n_rx = len(set_idx), len(set_idx[0])
    if any(len(row) != n_rx for row in set_idx):
        raise ValueError(f"set_idx rows differ in length: {set_idx}")
    for name, t in (("u_re", u_re), ("u_im", u_im), ("wgt", wgt), ("fct", fct),
                    ("fst", fst)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if u_re.dim() != 3 or u_im.shape != u_re.shape:
        raise ValueError(f"expected spectra [B, C, W*nv], got {tuple(u_re.shape)} "
                         f"and {tuple(u_im.shape)}")
    b, n_ch, m = u_re.shape
    if nv < 1 or m % nv:
        raise ValueError(f"row length {m} is not a multiple of nv={nv}")
    if tuple(wgt.shape) != (b, m // nv):
        raise ValueError(f"wgt: shape {tuple(wgt.shape)}, expected {(b, m // nv)}")
    if fct.dim() != 2 or fst.shape != fct.shape or fct.shape[1] != n_sets * n_rx:
        raise ValueError(f"fct/fst: shapes {tuple(fct.shape)}, {tuple(fst.shape)}; "
                         f"expected [Av, {n_sets * n_rx}]")
    if min(min(row) for row in set_idx) < 0 or max(max(row) for row in set_idx) >= n_ch:
        raise ValueError(f"set_idx {set_idx} out of range for {n_ch} channels")
    return n_sets, n_rx


def set_responses_reference(
    u_re: torch.Tensor, u_im: torch.Tensor, wgt: torch.Tensor,
    fct: torch.Tensor, fst: torch.Tensor, *, set_idx, nv: int,
) -> torch.Tensor:
    """Plain PyTorch responses: ``[B, C, W*nv] -> [B, S, Av, nv]``.

    The Pallas kernel's order (``_kernel_batch``): for each set accumulate
    ``fc*ur + fs*ui`` and ``fc*ui - fs*ur`` over the antennas in order, take
    ``sqrt(re*re + im*im)``, then add ``wgt[w] * mag_w`` for ``w = 0..W-1``
    in order.  Each is a separate float32 operation.
    """
    n_sets, n_rx = _check(u_re, u_im, wgt, fct, fst, set_idx, nv)
    b, _, m = u_re.shape
    win_rows = m // nv
    ure = u_re.reshape(b, -1, win_rows, nv)[:, None]  # [B, 1, C, W, nv]
    uim = u_im.reshape(b, -1, win_rows, nv)[:, None]
    out = []
    for s in range(n_sets):
        sp_re = sp_im = None
        for r in range(n_rx):
            ch = int(set_idx[s][r])
            ur, ui = ure[:, :, ch], uim[:, :, ch]  # [B, 1, W, nv]
            fc = fct[:, n_rx * s + r][None, :, None, None]  # [1, Av, 1, 1]
            fs = fst[:, n_rx * s + r][None, :, None, None]
            t_re = fc * ur + fs * ui
            t_im = fc * ui - fs * ur
            sp_re = t_re if sp_re is None else sp_re + t_re
            sp_im = t_im if sp_im is None else sp_im + t_im
        mag = torch.sqrt(sp_re * sp_re + sp_im * sp_im)  # [B, Av, W, nv]
        acc = wgt[:, 0, None, None] * mag[:, :, 0]
        for w in range(1, win_rows):
            acc = acc + wgt[:, w, None, None] * mag[:, :, w]
        out.append(acc)
    return torch.stack(out, dim=1)


def set_responses(
    u_re: torch.Tensor, u_im: torch.Tensor, wgt: torch.Tensor,
    fct: torch.Tensor, fst: torch.Tensor, *, set_idx, nv: int,
) -> torch.Tensor:
    """Sub-array responses ``[B, C, W*nv] -> [B, S, Av, nv]`` (TPU kernels #4, #5).

    Args:
        u_re, u_im: chirp-DFT'd spectra of the range window, rows ``(w, v)``
            flattened on the last axis.
        wgt: ``[B, W]`` range-window weights (the mask already divided by
            its sum: a weighted sum, not a mean).
        fct, fst: ``[Av, S*n_rx]`` transposed angle DFT factors; column
            ``s*n_rx + r`` is sub-array ``s``'s antenna ``r``.
        set_idx: ``S`` tuples of ``n_rx`` channel indices.
        nv: velocity bins per range row.
    """
    _check(u_re, u_im, wgt, fct, fst, set_idx, nv)
    if u_re.device.type == "cpu":
        return set_responses_reference(u_re, u_im, wgt, fct, fst,
                                       set_idx=set_idx, nv=nv)
    if u_re.device.type != "cuda":
        raise ValueError(f"no response kernel for device {u_re.device}")
    return kernel.doppler_az_responses(u_re, u_im, wgt, fct, fst,
                                       set_idx=set_idx, nv=nv)


def group_set_idx(n_groups: int, n_rx: int):
    """The channel table of the paired layout: row ``g*n_rx + r`` is group ``g``'s antenna ``r``."""
    return tuple(tuple(g * n_rx + r for r in range(n_rx)) for g in range(n_groups))


def group_responses(
    u_re: torch.Tensor, u_im: torch.Tensor, wgt: torch.Tensor,
    fct: torch.Tensor, fst: torch.Tensor, *, n_groups: int, n_rx: int, nv2: int,
) -> torch.Tensor:
    """Responses of the paired layout (TPU kernel #6): ``[B, G*n_rx, W*nv2] -> [B, G, Av, nv2]``.

    Two sets that share one factor matrix ride side by side: input row
    ``g*n_rx + r`` holds, for each range row, the two sets' ``nv`` bins back
    to back (``nv2 = 2*nv``).  The same function as :func:`set_responses`
    with the identity channel table, on the same kernel.
    """
    return set_responses(u_re, u_im, wgt, fct, fst,
                         set_idx=group_set_idx(n_groups, n_rx), nv=nv2)
