"""Qt-free shell wiring: the view grid's selection, payload routing and browse actions (JAX: ``visualization/shell_logic.py``).

All that the viewer's main window does besides drawing widgets lives here,
so it runs and tests without a Qt binding; ``qt_shell.py`` is a thin widget
layer over :class:`ShellLogic`:

- per-cell view selection with at most one cell a view and hidden-view
  payload caching, shown on reveal (through :class:`ViewPanelModel`);
- the dataset, radar-config and processor-parameter browse actions, which
  reload through the controller and rebuild the processor fan-out on the
  controller's device.

PyYAML is imported by ``browse_processor_params`` only.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from mmwave_radar_processing_tpu_torch.visualization.view_panel import ViewPanelModel
from mmwave_radar_processing_tpu_torch.visualization.views import VIEW_CLASSES


class ShellLogic:
    """Controller-bound shell state shared by any widget toolkit."""

    def __init__(self, controller, num_cells: int = 4,
                 initial_keys: Optional[List[Optional[str]]] = None):
        self.controller = controller
        self.num_cells = num_cells
        # combo options: every registered processor whose view class exists
        self.options: List[Optional[str]] = [None] + [
            key for key, spec in controller.registry.items()
            if spec.view_name in VIEW_CLASSES
        ]
        self.panel = ViewPanelModel(num_cells)
        self._views: Dict[int, object] = {}
        self._render_cb: Optional[Callable[[int], None]] = None
        keys = initial_keys if initial_keys is not None else self.options[1:num_cells + 1]
        for cell, key in enumerate(keys[:num_cells]):
            self.panel.select(cell, key)
        controller.subscribe_view_update(self.on_view_update)

    # rendering ------------------------------------------------------------ #
    def bind_cell_view(self, cell: int, view) -> None:
        """Attach the render target (a ``views.BaseView``) of ``cell``."""
        self._views[cell] = view

    def set_render_callback(self, fn: Callable[[int], None]) -> None:
        """Called with a cell index after its view re-renders (a canvas redraw)."""
        self._render_cb = fn

    def view_class_for(self, key: str):
        return VIEW_CLASSES[self.controller.registry[key].view_name]

    def _render(self, cell: int, payload: dict) -> None:
        view = self._views.get(cell)
        if view is not None:
            view.set_data(payload)
            if self._render_cb:
                self._render_cb(cell)

    # selection (combobox handler) ------------------------------------------ #
    def select_view(self, cell: int, key: Optional[str]) -> List[int]:
        """Assign ``key`` to ``cell`` and render its cached payload, if any.

        Returns the cells whose assignment changed (the target and any cell
        the uniqueness rule cleared), so the widget layer can sync its
        comboboxes.
        """
        before = list(self.panel.assignments)
        cached = self.panel.select(cell, key)
        changed = [
            i for i, (a, b) in enumerate(zip(before, self.panel.assignments))
            if a != b
        ]
        if cached is not None:
            self._render(cell, cached)
        return changed

    # payload stream --------------------------------------------------------- #
    def on_view_update(self, key: str, payload: dict) -> List[int]:
        """Cache the payload and render it in whichever cells show ``key``."""
        cells = self.panel.handle_view_update(key, payload)
        for cell in cells:
            self._render(cell, payload)
        return cells

    # browse actions ----------------------------------------------------------- #
    def browse_dataset(self, dataset_path: str, **folders) -> int:
        """Point the controller at a new dataset directory; returns its frames."""
        return self.controller.load_dataset(dataset_path, **folders)

    def browse_config(self, cfg_path: str, array_geometry: str = "standard",
                      array_direction: str = "down"):
        """Load a radar .cfg and rebuild the processor fan-out."""
        cfg = self.controller.load_config(cfg_path, array_geometry,
                                          array_direction)
        self.controller.init_processors()
        return cfg

    def browse_processor_params(self, params_path: str) -> None:
        """Load a processor-parameter YAML and rebuild the fan-out."""
        import yaml

        with open(params_path) as f:
            self.controller.processor_params = yaml.safe_load(f).get(
                "processors", {}
            )
        if self.controller.config_model.config is not None:
            self.controller.init_processors()
