"""The viewer: processor registry, playback controller, precompute cache, and its drawing side (JAX: ``visualization/``).

- :mod:`.processor_registry` — the ``ProcessorSpec`` dataclass and the
  default registry of fourteen processors with their view pairings and
  payload contracts.
- :mod:`.controller` — the playback controller (dataset and config models,
  the per-frame processor fan-out on one device, payload emission) with
  plain observer callbacks, so the pipeline runs and tests headless; a UI
  subscribes to the same callbacks.  Payloads are host arrays (``to_host``).
- :mod:`.precompute` — ``PrecomputedPlayback``: the whole recording's
  payloads from the batched device pipelines (``parallel.viewer_pipeline``),
  cached on the host and served during playback and scrubbing.
- :mod:`.view_panel` — the view grid's selection model and payload cache.
- :mod:`.views` — matplotlib views of the payloads (dB toggling, detection
  overlays); :mod:`.pyqtgraph_views` — the real-time pyqtgraph tier.
- :mod:`.shell_logic` — the shell's selection, routing and browse actions
  without Qt; :mod:`.qt_shell` — the PyQt6 window over it.
- :mod:`.video_exporter` — the controller's frames drawn into a movie.

The processors run on the controller's device and the drawing on the host.
Nothing here imports PyYAML, matplotlib, imageio or Qt at module level:
each is imported where it is used.
"""

from mmwave_radar_processing_tpu_torch.visualization.processor_registry import (
    ProcessorSpec,
    get_default_registry,
)
from mmwave_radar_processing_tpu_torch.visualization.controller import (
    ConfigModel,
    DatasetModel,
    MmWaveRadarProcessorController,
    mmWaveRadarProcessorController,
)

__all__ = [
    "mmWaveRadarProcessorController",
    "ProcessorSpec",
    "get_default_registry",
    "ConfigModel",
    "DatasetModel",
    "MmWaveRadarProcessorController",
]
