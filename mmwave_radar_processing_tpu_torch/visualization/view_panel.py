"""View-panel selection model, the headless core of the 2x2 view grid (JAX: ``visualization/view_panel.py``).

A grid of cells, each showing one processor view.  Payloads are cached per
view key, so a view revealed later renders the most recent frame at once,
and a view key is active in at most one cell at a time: selecting it
elsewhere clears the other cell.  Pure Python, no Qt.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional


class ViewPanelModel:
    """Grid-cell -> view-key assignment with payload caching and uniqueness."""

    def __init__(self, num_cells: int = 4,
                 on_assign: Optional[Callable[[int, Optional[str]], None]] = None):
        self.num_cells = num_cells
        self.assignments: List[Optional[str]] = [None] * num_cells
        self.latest_payloads: Dict[str, dict] = {}
        self.on_assign = on_assign

    def select(self, cell: int, view_key: Optional[str]) -> Optional[dict]:
        """Assign ``view_key`` to ``cell``; enforce at most one cell per view.

        Returns the cached payload for immediate rendering (or None).
        """
        if view_key is not None:
            for other, key in enumerate(self.assignments):
                if other != cell and key == view_key:
                    self.assignments[other] = None
                    if self.on_assign:
                        self.on_assign(other, None)
        self.assignments[cell] = view_key
        if self.on_assign:
            self.on_assign(cell, view_key)
        return self.latest_payloads.get(view_key) if view_key else None

    def handle_view_update(self, view_key: str, payload: dict) -> List[int]:
        """Cache the payload; return the cells that must re-render now."""
        self.latest_payloads[view_key] = payload
        return [i for i, key in enumerate(self.assignments) if key == view_key]

    def cell_of(self, view_key: str) -> Optional[int]:
        try:
            return self.assignments.index(view_key)
        except ValueError:
            return None
