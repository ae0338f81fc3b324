"""Playback controller and dataset/config models, the viewer's headless backend (JAX: ``visualization/controller.py``).

It loads a dataset, a radar config and per-processor parameters, builds the
processor fan-out on one device, processes frames and emits ``(view_key,
payload)`` updates to plain observer callbacks, so the whole pipeline runs
and tests without a UI; a UI subscribes to the same callbacks.

Payload protocol: each processor's payload is ``{"data": result}`` plus every
attribute named in its spec's ``view_keys``, read off the processor after
``process``.  Payloads hold host (numpy) arrays; every processor runs on the
controller's device.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from mmwave_radar_processing_tpu_torch.config import RadarConfig, load_cfg
from mmwave_radar_processing_tpu_torch.data.cpsl_dataset import CpslDS
from mmwave_radar_processing_tpu_torch.processors.base import resolve_device, to_host
from mmwave_radar_processing_tpu_torch.processors.virtual_array import VirtualArrayReformatter
from mmwave_radar_processing_tpu_torch.utils.logger import get_logger
from mmwave_radar_processing_tpu_torch.visualization.processor_registry import (
    ProcessorSpec,
    get_default_registry,
)


class DatasetModel:
    """Wraps ``CpslDS``: ADC access and the NED velocity from odometry."""

    def __init__(self):
        self.dataset: Optional[CpslDS] = None

    def load_dataset(self, dataset_path: str, **folders) -> int:
        self.dataset = CpslDS(dataset_path, **folders)
        return self.dataset.num_frames

    @property
    def num_frames(self) -> int:
        return self.dataset.num_frames if self.dataset else 0

    def get_adc_data(self, idx: int) -> np.ndarray:
        return self.dataset.get_radar_adc_data(idx)

    def get_adc_paths(self) -> List[str]:
        """Every frame's ADC file, in frame order."""
        return self.dataset.get_radar_adc_paths()

    def get_velocity_ned(self, idx: int) -> np.ndarray:
        """Mean of the odometry velocity columns 8:11 (zeros without odometry)."""
        if not self.dataset.vehicle_odom_enabled:
            return np.zeros(3)
        odom = self.dataset.get_vehicle_odom_data(idx)
        return np.mean(odom[:, 8:11], axis=0)


class ConfigModel:
    """Wraps config loading and the derived performance parameters."""

    def __init__(self):
        self.config: Optional[RadarConfig] = None

    def load(self, cfg_path: str, array_geometry="standard", array_direction="down"):
        self.config = load_cfg(cfg_path, array_geometry, array_direction)
        return self.config


class MmWaveRadarProcessorController:
    """Frame-playback controller with observer-callback signals, on one ``device``.

    Playback, the models and the per-processor fan-out (the YAML parameters
    passed verbatim, the ``view_keys`` payload protocol) in one headless
    object.  ``device`` defaults to ``"cuda"`` and raises when no CUDA device
    is present; pass ``device="cpu"`` to run on the CPU.

    Callbacks:
    - ``on_view_update(key: str, payload: dict)``
    - ``on_frame_processed(idx: int)``
    - ``on_dataset_loaded(num_frames: int)``
    """

    def __init__(
        self,
        registry: Optional[Dict[str, ProcessorSpec]] = None,
        dataset_params_path: Optional[str] = None,
        processor_params_path: Optional[str] = None,
        max_history: int = 20,
        *,
        device="cuda",
    ):
        self.logger = get_logger(__name__)
        self.device = resolve_device(device)
        self.registry = registry or get_default_registry()
        self.dataset_model = DatasetModel()
        self.config_model = ConfigModel()
        self.processors: Dict[str, object] = {}
        self.processor_params: Dict[str, dict] = {}
        self.reformatter: Optional[VirtualArrayReformatter] = None
        self.adc_buffer = deque(maxlen=max_history)
        self.current_frame = 0
        self.playback_cache = None  # PrecomputedPlayback when enabled

        self._view_subscribers: List[Callable] = []
        self._frame_subscribers: List[Callable] = []
        self._dataset_subscribers: List[Callable] = []

        if dataset_params_path:
            self.load_defaults(dataset_params_path, processor_params_path)

    # signal wiring ------------------------------------------------------ #
    def subscribe_view_update(self, fn: Callable) -> None:
        self._view_subscribers.append(fn)

    def subscribe_frame_processed(self, fn: Callable) -> None:
        self._frame_subscribers.append(fn)

    def unsubscribe_view_update(self, fn: Callable) -> None:
        self._view_subscribers.remove(fn)

    def subscribe_dataset_loaded(self, fn: Callable) -> None:
        self._dataset_subscribers.append(fn)

    def _emit_view(self, key, payload):
        for fn in self._view_subscribers:
            fn(key, payload)

    # loading ------------------------------------------------------------- #
    def load_defaults(self, dataset_params_path: str,
                      processor_params_path: Optional[str] = None) -> None:
        """Resolve the YAML dataset/config description and processor parameters.

        Needs PyYAML, imported here only: ``load_dataset``, ``load_config``,
        setting ``processor_params`` and ``init_processors`` work without it.
        """
        import yaml

        with open(dataset_params_path) as f:
            params = yaml.safe_load(f)
        root = os.path.dirname(os.path.abspath(dataset_params_path))

        ds = params.get("dataset", {})
        dataset_path = ds.get("dataset_path", "")
        if dataset_path and not os.path.isabs(dataset_path):
            dataset_path = os.path.join(root, dataset_path)
        folders = {
            k: v
            for k, v in ds.items()
            if k.endswith("_folder") and isinstance(v, str)
        }
        if dataset_path:
            self.load_dataset(dataset_path, **folders)

        cfgd = params.get("config", {})
        cfg_name = cfgd.get("name")
        if cfg_name:
            cfg_path = cfg_name if os.path.isabs(cfg_name) else os.path.join(
                root, cfg_name
            )
            if not os.path.exists(cfg_path):
                cfg_path = os.path.join(root, "..", "configs", cfg_name)
            self.load_config(
                cfg_path,
                array_geometry=cfgd.get("array_geometry", "standard"),
                array_direction=cfgd.get("array_direction", "down"),
            )

        if processor_params_path:
            with open(processor_params_path) as f:
                self.processor_params = yaml.safe_load(f).get("processors", {})
            if self.config_model.config is not None:
                self.init_processors()

    def load_dataset(self, dataset_path: str, **folders) -> int:
        n = self.dataset_model.load_dataset(dataset_path, **folders)
        for fn in self._dataset_subscribers:
            fn(n)
        self.logger.info("dataset loaded: %d frames", n)
        return n

    def load_config(self, cfg_path: str, array_geometry="standard",
                    array_direction="down"):
        cfg = self.config_model.load(cfg_path, array_geometry, array_direction)
        self.logger.info("config loaded: %s", os.path.basename(cfg_path))
        return cfg

    def init_processors(self) -> None:
        """Build the reformatter and every enabled registry processor on the controller's device."""
        cfg = self.config_model.config
        self.reformatter = VirtualArrayReformatter(cfg, device=self.device)
        self.processors = {}
        for key, spec in self.registry.items():
            if not spec.enabled:
                continue
            params = dict(self.processor_params.get(key, {}))
            ctor_params = {
                k: v for k, v in params.items() if not k.startswith("_")
            }
            try:
                self.processors[key] = spec.processor_cls(cfg, device=self.device,
                                                          **ctor_params)
            except Exception as e:  # keep the rest of the fan-out alive
                self.logger.warning("processor %s failed to init: %s", key, e)

    # processing ----------------------------------------------------------- #
    def enable_precomputed_playback(self, keys=None, batch_size: int = 64):
        """Precompute the payloads of the whole recording on the controller's device.

        Every coverable enabled processor's math runs through the batched
        pipelines (``parallel/viewer_pipeline.py``, the Capon pipeline and
        the ground scan); later :meth:`process_next_frame` calls serve those
        keys from the host cache, so the processing leg of a playback tick
        becomes a dict lookup.  Uncovered processors keep the per-frame path.
        Returns the set of covered keys.
        """
        from mmwave_radar_processing_tpu_torch.visualization.precompute import (
            PrecomputedPlayback,
        )

        self.playback_cache = PrecomputedPlayback(self, keys=keys,
                                                  batch_size=batch_size)
        return self.playback_cache.build()

    def disable_precomputed_playback(self) -> None:
        self.playback_cache = None

    def process_next_frame(self, idx: int) -> None:
        """Fetch -> reformat -> fan out to all processors -> emit payloads.

        Per-processor keywords come verbatim from the YAML parameters;
        processors whose spec requires velocity receive ``velocity_ned``.
        With :meth:`enable_precomputed_playback` active, covered keys emit
        cached payloads instead of recomputing.
        """
        self.current_frame = idx
        cache = self.playback_cache
        cached_keys = {
            k for k in self.processors if cache is not None and cache.covers(k)
        }
        frame_inputs = {}

        def ensure_frame_inputs():
            """Fetch and reformat the frame lazily, at most once.

            Called up front when some processor runs per frame, and again on
            a cache miss (``idx`` outside the cached range), so that a miss
            recomputes the frame instead of handing the processor no cube.
            """
            if frame_inputs:
                return
            adc = self.dataset_model.get_adc_data(idx)
            frame_inputs["velocity_ned"] = self.dataset_model.get_velocity_ned(idx)
            adc = self.reformatter.process(adc)  # complex64 on the device
            self.adc_buffer.append(adc)
            frame_inputs["adc"] = adc

        if set(self.processors) - cached_keys:
            ensure_frame_inputs()

        for key, proc in self.processors.items():
            spec = self.registry[key]
            if key in cached_keys:
                payload = cache.payload(key, idx)
                if payload is not None:
                    # static view_keys attributes (bin grids) come off the
                    # live processor, as on the per-frame path
                    for attr in spec.view_keys:
                        if attr not in payload and hasattr(proc, attr):
                            payload[attr] = to_host(getattr(proc, attr))
                    self._emit_view(key, payload)
                    continue
                ensure_frame_inputs()  # cache miss -> per-frame recompute
            kwargs = dict(self.processor_params.get(key, {}))
            if spec.requires_velocity:
                kwargs["velocity_ned"] = frame_inputs.get("velocity_ned")
            try:
                result = proc.process(frame_inputs.get("adc"), **kwargs)
            except Exception as e:  # one broken view does not stop playback
                self.logger.warning("processor %s failed on frame %d: %s",
                                    key, idx, e)
                continue
            if isinstance(result, tuple):
                # a multi-output process (the Doppler-azimuth precise path
                # returns (resp, zoomed_vel_bins, row_valid)): the response is
                # the data, the rest rides in view_keys attributes
                result = result[0]
            payload = {"data": to_host(result)}
            for attr in spec.view_keys:
                if hasattr(proc, attr):
                    payload[attr] = to_host(getattr(proc, attr))
            self._emit_view(key, payload)

        for fn in self._frame_subscribers:
            fn(idx)

    def play(self, start: int = 0, end: Optional[int] = None) -> None:
        """Process a frame range synchronously (a UI drives a timer)."""
        end = end if end is not None else self.dataset_model.num_frames
        for i in range(start, end):
            self.process_next_frame(i)

    def export_movie(self, out_path: str, plotter, fps: int = 20) -> int:
        """Render the default views of every frame into a movie; returns the frames written.

        ``plotter`` is accepted for the reference's signature and not used:
        the exporter draws the first four processors' views.  (The JAX
        package's method hands it to ``VideoExporter`` as its view keys,
        which raises ``TypeError`` for any plotter but ``None``.)
        """
        from mmwave_radar_processing_tpu_torch.visualization.video_exporter import (
            VideoExporter,
        )

        return VideoExporter(self, fps=fps).export(out_path)


# the reference's name
mmWaveRadarProcessorController = MmWaveRadarProcessorController
