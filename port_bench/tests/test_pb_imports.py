"""What each part of the benchmark may import, by top-level module name compared whole."""

import ast
import sys
import types

import pytest

from conftest import BENCH_DIR

JAX_SIDE = {"jax", "jaxlib", "flax", "mmwave_radar_processing_tpu"}
PORT = "mmwave_radar_processing_tpu_torch"


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & JAX_SIDE


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name in ("reference", "gen")],
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_reference_and_generator_import_nothing_of_the_port(path):
    assert PORT not in imported_tops(path)


def test_the_run_refuses_by_whole_top_level_name(monkeypatch):
    from port_bench.lib.harness import forbidden_modules

    monkeypatch.setitem(sys.modules, "mmwave_radar_processing_tpu_torch_probe", types.ModuleType("x"))
    assert "mmwave_radar_processing_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "mmwave_radar_processing_tpu.probe", types.ModuleType("y"))
    assert "mmwave_radar_processing_tpu" in forbidden_modules()
