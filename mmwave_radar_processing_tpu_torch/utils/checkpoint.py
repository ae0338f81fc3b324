"""Checkpoint / resume of the port's processor states (JAX: ``utils/checkpoint.py``).

A state tree is what the stateful stages carry from frame to frame: the
altimeter's ``AltimeterState``, the micro-Doppler history (a tensor), the
synthetic array's ``SyntheticArrayState``, the ground pipeline's
``final_altitude``, nested in ``NamedTuple``\\ s, tuples, lists and dicts.  A
tree checkpoints as one flat ``.npz`` in the JAX package's format, so a file
written by either package loads in the other:

- ``leaf{i}`` holds the i-th leaf; a complex leaf is split into
  ``leaf{i}::re`` and ``leaf{i}::im``;
- ``__metadata__`` holds optional JSON, ``__treedef__`` a description of the
  tree that loading ignores (the two packages describe trees differently).

Leaves are numbered as ``jax.tree.flatten`` numbers them: a dict's values in
sorted key order (``torch.utils._pytree`` keeps insertion order instead, and
the two files would then disagree leaf by leaf while every shape matched),
``None`` holds no leaf.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.utils.logger import get_logger

_COMPLEX_SUFFIX_RE = "::re"
_COMPLEX_SUFFIX_IM = "::im"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in flatten(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for child in tree for leaf in flatten(child)]
    return [tree]


def unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves taken in :func:`flatten`'s order from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        values = {key: unflatten(like[key], leaves) for key in sorted(like)}
        return type(like)((key, values[key]) for key in like)
    if _is_namedtuple(like):
        return type(like)(*(unflatten(child, leaves) for child in like))
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(child, leaves) for child in like)
    return next(leaves)


def _describe(tree: Any) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {_describe(tree[key])}" for key in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(child) for child in tree)
        name = type(tree).__name__ if _is_namedtuple(tree) else ""
        return f"{name}[{inner}]" if isinstance(tree, list) else f"{name}({inner})"
    return "*"


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path: str, state_tree: Any, metadata: Dict | None = None) -> None:
    """Write a state tree (+ optional JSON metadata) to ``path`` (.npz), atomically."""
    leaves = flatten(state_tree)
    arrays = {}
    for i, leaf in enumerate(leaves):
        arr = _as_numpy(leaf)
        if np.iscomplexobj(arr):
            arrays[f"leaf{i}{_COMPLEX_SUFFIX_RE}"] = np.real(arr)
            arrays[f"leaf{i}{_COMPLEX_SUFFIX_IM}"] = np.imag(arr)
        else:
            arrays[f"leaf{i}"] = arr
    arrays["__treedef__"] = np.frombuffer(_describe(state_tree).encode(), dtype=np.uint8)
    if metadata:
        arrays["__metadata__"] = np.frombuffer(json.dumps(metadata).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
    get_logger(__name__).info("checkpointed %d state leaves to %s", len(leaves), path)


def _restore_leaf(arr: np.ndarray, ref, i: int):
    ref_shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) else np.shape(ref)
    if arr.shape != ref_shape:
        raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != expected {ref_shape}")
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(arr, order="C")).to(device=ref.device,
                                                              dtype=ref.dtype)
    return arr.astype(np.asarray(ref).dtype)


def load_state(path: str, like_tree: Any):
    """Restore a state tree checkpointed by :func:`save_state` (by either package).

    ``like_tree`` supplies the structure, and each tensor leaf the device and
    dtype its value is restored to (e.g. ``processor.init_state()``); leaf
    values come from the checkpoint.  Returns ``(state, metadata)``.
    """
    with np.load(path) as data:
        restored = []
        for i, ref in enumerate(flatten(like_tree)):
            if f"leaf{i}" in data:
                arr = data[f"leaf{i}"]
            else:
                arr = (data[f"leaf{i}{_COMPLEX_SUFFIX_RE}"]
                       + 1j * data[f"leaf{i}{_COMPLEX_SUFFIX_IM}"])
            restored.append(_restore_leaf(arr, ref, i))
        metadata = None
        if "__metadata__" in data:
            metadata = json.loads(bytes(data["__metadata__"]).decode())
    return unflatten(like_tree, iter(restored)), metadata


class PipelineCheckpointer:
    """Periodic checkpointing of a dict of named processor states."""

    def __init__(self, directory: str, every_n_frames: int = 100):
        self.directory = directory
        self.every = every_n_frames
        os.makedirs(directory, exist_ok=True)

    def path(self) -> str:
        return os.path.join(self.directory, "pipeline_state.npz")

    def maybe_save(self, frame_idx: int, states: Dict[str, Any]) -> bool:
        if frame_idx % self.every != 0 or frame_idx == 0:
            return False
        save_state(self.path(), states, metadata={"frame_idx": frame_idx})
        return True

    def restore(self, like_states: Dict[str, Any]):
        """Returns ``(states, resume_frame)`` or ``(like_states, 0)`` if none."""
        if not os.path.exists(self.path()):
            return like_states, 0
        states, meta = load_state(self.path(), like_states)
        return states, int(meta["frame_idx"]) if meta else 0
