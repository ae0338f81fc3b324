"""`.env` directory-root convention of the port (JAX: ``utils/env.py``).

The reference resolves dataset/config/movie/analyzer roots from a ``.env``
file via python-dotenv.  This is a dependency-free equivalent: ``load_env()``
parses ``KEY=VALUE`` lines (``#`` comments ignored) from the nearest ``.env``
up the directory tree and merges them under os.environ (existing variables
win), and ``resolve_dir`` joins relative paths onto the matching root.

Recognized keys (same as the reference): ``DATASET_DIRECTORY``,
``CONFIG_DIRECTORY``, ``MOVIE_TEMP_DIRECTORY``, ``ANALYZER_TEMP_DIRECTORY``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

KEYS = (
    "DATASET_DIRECTORY",
    "CONFIG_DIRECTORY",
    "MOVIE_TEMP_DIRECTORY",
    "ANALYZER_TEMP_DIRECTORY",
)


def find_env_file(start: Optional[str] = None) -> Optional[str]:
    """Nearest ``.env`` walking up from ``start`` (default: cwd)."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        candidate = os.path.join(d, ".env")
        if os.path.isfile(candidate):
            return candidate
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def load_env(path: Optional[str] = None) -> Dict[str, str]:
    """Parse a ``.env`` file and export new keys to ``os.environ``.

    Returns the parsed mapping (empty if no file found).  Existing environment
    variables are not overwritten, matching python-dotenv defaults.
    """
    path = path or find_env_file()
    if not path or not os.path.isfile(path):
        return {}
    parsed: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip().strip("'\"")
            parsed[key] = value
            os.environ.setdefault(key, value)
    return parsed


def resolve_dir(path: str, root_key: str) -> str:
    """Join a relative path onto the ``root_key`` directory when set."""
    if os.path.isabs(path):
        return path
    root = os.environ.get(root_key, "")
    return os.path.join(root, path) if root else path
