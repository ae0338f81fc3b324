"""Operations and bytes of the hand-written kernels, from shapes alone, and the card's peaks.

The method of the port's kernel table: a kernel's least time is the larger
of the operations it needs over the float32 peak (an FMA two operations, a
compare one) and its compulsory bytes (inputs read once, outputs written
once) over the memory bandwidth.  A roofline share is that bound over the
measured kernel time.  The counts are of the algorithm at the call's shapes,
whatever implements it.

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W limit: 67 TFLOP/s
float32 outside the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Sequence, Tuple

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12


def bound_seconds(ops: float, nbytes: float) -> float:
    """The least time of a call: operations over the float32 peak or bytes over HBM, the larger."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def os_cfar_detect_compact(batch: int, rows: int, cols: int, *, num_train: Sequence[int],
                           num_guard: Sequence[int], capacity: int) -> Tuple[float, float]:
    """``(ops, bytes)`` of counting OS-CFAR with compaction on ``float32 [batch, rows, cols]``.

    Every cell whose window lies on the map scales each training cell
    (one multiply), compares it (one) and counts it (one add).  Out: int64
    row and column, bool valid per slot, an int32 count per frame.
    """
    er, ed = num_train[0] + num_guard[0], num_train[1] + num_guard[1]
    n_train = (2 * er + 1) * (2 * ed + 1) - (2 * num_guard[0] + 1) * (2 * num_guard[1] + 1)
    interior = max(rows - 2 * er, 0) * max(cols - 2 * ed, 0)
    ops = 3.0 * batch * interior * n_train
    nbytes = 4.0 * batch * rows * cols + batch * capacity * (8 + 8 + 1) + 4.0 * batch
    return ops, nbytes


def doppler_az_responses(batch: int, channels: int, win_rows: int, nv: int, *, n_angles: int,
                         n_sets: int, n_rx: int) -> Tuple[float, float]:
    """``(ops, bytes)`` of the sub-array responses ``[B, C, W*nv] -> [B, S, Av, nv]``.

    Per output and window row: each antenna's complex product by a real
    factor pair (6 operations) and its sum into the angle bin (2), then the
    magnitude and its weighted accumulation (4).  In: the split spectra, the
    weights and the factor tables; out: float32 responses.
    """
    ops = (8.0 * n_rx + 4.0) * batch * n_sets * n_angles * win_rows * nv
    nbytes = 4.0 * (2 * batch * channels * win_rows * nv + batch * win_rows
                    + 2 * n_angles * n_sets * n_rx + batch * n_sets * n_angles * nv)
    return ops, nbytes


def prominent_peak(rows: int, n: int) -> Tuple[float, float]:
    """``(ops, bytes)`` of the velocity peak picker on ``float32 [rows, n]``.

    One compare a sample finds the local maxima; the prominence walks
    depend on the data and are not counted.  In: the rows; out: an int64
    index and a one-byte found flag a row.
    """
    return float(rows * n), 4.0 * rows * n + 9.0 * rows
