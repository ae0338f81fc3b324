"""Rows for the tests of the velocity peak picker: where a fast form could part from the plain one.

numpy only: the card's tests import no JAX.  Every generator returns float32
``[rows, n]``.
"""

import numpy as np

#: row lengths: no interior sample (1, 2), one and two (3, 4), either side of
#: a warp's 32 lanes and of two warps' worth, the velocity path's 60 angle
#: bins, the zoom pass's 140, and the kernel's widest row
WIDTHS = (1, 2, 3, 4, 31, 32, 33, 60, 64, 65, 140, 1024)
#: prominence floors: below every prominence, every peak, integer and
#: half-integer steps of the quantised rows (prominences land on them
#: exactly), and the velocity path's
THRESHOLDS = (-1.0, 0.0, 1.0, 2.5, 4.0)


def quantised_rows(rows, n, seed, levels=6):
    """Half-integer levels: ties in value and prominences exactly at the floors."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2 * levels, (rows, n)) / 2).astype(np.float32)


def db_rows(rows, n, seed):
    """dB of exponential magnitudes floored 30 dB below the row's top, as the velocity path's maps."""
    rng = np.random.default_rng(seed)
    db = 20 * np.log10(rng.exponential(1.0, (rows, n)) + 1e-3)
    return np.maximum(db, db.max(axis=1, keepdims=True) - 30).astype(np.float32)


def special_rows(n, seed):
    """Flat, monotone and plateau rows, the most peaks a row holds, signed zeros, NaN and infinities."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    base = np.round(rng.uniform(-3, 3, n) * 2) / 2
    rows = [np.full(n, 1.5), i.astype(float), -i.astype(float),
            np.where(i % 4 == 1, 3.0, 0.0) + np.where(i % 4 == 2, 3.0, 0.0),  # plateaus
            (i % 2).astype(float),  # a peak at every odd sample
            np.where(i % 2 == 1, i, 0).astype(float),  # rising peaks: each walks far left
            np.where(i % 2 == 1, n - i, 0).astype(float),  # falling peaks: far right
            np.where(i % 2 == 1, np.where(i % 4 == 1, -0.0, 0.0), -1.0)]  # peaks of -0.0, 0.0
    for value in (np.nan, np.inf, -np.inf):
        for _ in range(3):
            row = base.copy()
            row[rng.integers(0, n, max(1, n // 16))] = value
            rows.append(row)
    if n >= 7:
        row = base.copy()
        row[:3] = (0.0, 10.0, 0.0)
        row[n - 4:n - 1] = (0.0, np.inf, 0.0)  # an infinite peak, and a finite one
        rows.append(row)
        row = np.zeros(n)
        row[n // 2] = 5.0
        row[n - 2] = np.nan  # a NaN in the right base of the only peak
        rows.append(row)
        row = np.zeros(n)
        row[[1, 3]] = 5.0
        row[2] = np.nan  # NaN between two peaks: neither is a strict maximum on that side
        rows.append(row)
    return np.stack(rows).astype(np.float32)


def model_best_prominent_peak(x, min_prominence):
    """The kernel's algorithm in numpy, one row at a time: ``(index int64, found bool)``.

    Strict interior maxima; from each, a walk outwards to the nearest
    strictly higher sample (or the end) keeping the minimum and noting a NaN;
    the prominence as one float32 subtraction; the highest passing peak,
    the lowest index on ties.
    """
    x = np.asarray(x, np.float32)
    n = x.shape[-1]
    flat = x.reshape(-1, n)
    thr = np.float32(min_prominence)
    index = np.zeros(len(flat), np.int64)
    found = np.zeros(len(flat), bool)
    with np.errstate(invalid="ignore"):
        for r, row in enumerate(flat):
            best = None
            for i in range(1, n - 1):
                v = row[i]
                if not (row[i - 1] < v and v > row[i + 1]) or not np.isfinite(v):
                    continue
                bases, nan = [], False
                for step in (-1, 1):
                    low, j = v, i + step
                    while 0 <= j < n and not row[j] > v:
                        low = np.fmin(low, row[j])
                        nan |= bool(np.isnan(row[j]))
                        j += step
                    bases.append(low)
                if nan or not np.float32(v - np.fmax(*bases)) >= thr:
                    continue
                if best is None or v > row[best]:
                    best = i
            if best is not None:
                index[r], found[r] = best, True
    return index.reshape(x.shape[:-1]), found.reshape(x.shape[:-1])
