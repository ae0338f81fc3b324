"""The sorting networks of the k-th-smallest kernel, and the header that carries them.

A row of up to ``MAX_WIDTH`` columns is sorted by one thread in registers
(``csrc/os_rank_select.cu``): a fixed list of compare-exchanges
``(i, j)``, ``i < j``, each leaving the smaller key at ``i``.  The list for a
width ``w`` is Batcher's odd-even merge sort of the next power of two, pruned:
the pad keys above ``w`` are the largest key and sit at the top, so a
compare-exchange that touches one changes nothing and is dropped.  The list is
made here, in one place: :func:`header` writes it out as C++ for the build
(:mod:`._build`), and the CPU tests hold the same list to the 0-1 principle.
No torch here: the build imports this module.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

#: rows up to this width are sorted by one thread (32 keys in registers)
MAX_WIDTH = 32
HEADER_NAME = "kth_network.h"

Comparator = Tuple[int, int]


def batcher_comparators(size: int) -> List[Comparator]:
    """Batcher's odd-even merge sort of ``size`` keys, a power of two, in order of use."""
    if size < 1 or size & (size - 1):
        raise ValueError(f"size {size} is not a power of two")
    out = []
    merged = 1  # length of the sorted runs that this round merges in pairs
    while merged < size:
        k = merged
        while k >= 1:
            for j in range(k % merged, size - k, 2 * k):
                for i in range(min(k, size - j - k)):
                    if (i + j) // (2 * merged) == (i + j + k) // (2 * merged):
                        out.append((i + j, i + j + k))
            k //= 2
        merged *= 2
    return out


@functools.lru_cache(maxsize=None)
def comparators(width: int) -> Tuple[Comparator, ...]:
    """The network of a row of ``width`` keys: the padded size's, less what touches a pad."""
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"width {width} outside 1..{MAX_WIDTH}")
    padded = 1 << (width - 1).bit_length()
    return tuple((i, j) for i, j in batcher_comparators(padded) if j < width)


def header() -> str:
    """``kth_network.h``: ``kth_sort_network<W>(key)`` for every width, as straight-line code.

    The including source defines ``KTH_CE(i, j)``, the compare-exchange of
    ``key[i]`` and ``key[j]``.  Every index is a literal, so the keys stay in
    registers.
    """
    lines = [
        "// Generated by mmwave_radar_processing_tpu_torch/ops/kernels/sorting_network.py",
        "// (header()): Batcher's odd-even merge sort for each row width, pruned of the",
        "// compare-exchanges that touch a pad.  Do not edit.",
        "#pragma once",
        "#include <stdint.h>",
        "template <int kW>",
        "__device__ __forceinline__ void kth_sort_network(uint32_t (&key)[kW]);",
    ]
    for width in range(1, MAX_WIDTH + 1):
        body = " ".join(f"KTH_CE({i}, {j})" for i, j in comparators(width))
        lines += [
            "template <>",
            f"__device__ __forceinline__ void kth_sort_network<{width}>"
            f"(uint32_t (&key)[{width}]) {{",
            f"  {body}" if body else "  (void)key;",
            "}",
        ]
    return "\n".join(lines) + "\n"
