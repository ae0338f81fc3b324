"""The viewer's headless backend: processor registry, playback controller, precompute cache (JAX: ``visualization/``).

- :mod:`.processor_registry` — the ``ProcessorSpec`` dataclass and the
  default registry of fourteen processors with their view pairings and
  payload contracts.
- :mod:`.controller` — the playback controller (dataset and config models,
  the per-frame processor fan-out on one device, payload emission) with
  plain observer callbacks, so the pipeline runs and tests headless; a UI
  subscribes to the same callbacks.
- :mod:`.precompute` — ``PrecomputedPlayback``: the whole recording's
  payloads from the batched device pipelines (``parallel.viewer_pipeline``),
  cached on the host and served during playback and scrubbing.
- :mod:`.view_panel` — the view grid's selection model and payload cache.

Nothing here imports PyYAML, matplotlib or Qt at module level; the drawing
side (views, the Qt shell, the video exporter) is not ported yet.
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
