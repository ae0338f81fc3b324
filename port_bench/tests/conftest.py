"""The benchmark's own tests: CPU only, tiny cells made as copies of the real files."""

import json
import shutil
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

BENCH_DIR = CHECKOUT / "port_bench"
TINY = {"frames": 16, "batch": 8}


def tiny_cell(root: Path, real: str, name: str, **mix_changes) -> str:
    """Add to ``root`` a copy of cell ``real`` whose traffic mix is cut to a few frames; returns its name."""
    cell = json.loads((root / "workloads" / f"{real}.json").read_text())
    mix = json.loads((root / "traffic" / "mixes" / f"{cell['traffic']}.json").read_text())
    mix.update(TINY, **mix_changes)
    if "loader_threads" in mix:
        mix["loader_threads"] = 2
    (root / "traffic" / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    cell.update(name=name, traffic=name, sample_frames=12)
    (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return name


@pytest.fixture(scope="session")
def bench_copy(tmp_path_factory) -> Path:
    """A copy of the benchmark's folder with a tiny copy of every cell, named ``tiny-<cell>``."""
    root = tmp_path_factory.mktemp("bench") / "port_bench"
    shutil.copytree(BENCH_DIR, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for path in sorted((BENCH_DIR / "workloads").glob("*.json")):
        tiny_cell(root, path.stem, f"tiny-{path.stem}")
    return root
