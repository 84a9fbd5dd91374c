"""Every cell's configuration, traffic, loop and metric files are found by
name from BENCHMARK.json, and an added file adds a cell or a metric without
an edit."""

from __future__ import annotations

import json
import os
import shutil

from port_bench import registry


def test_every_cell_finds_its_files():
    bench = registry.load_benchmark()
    for cell in bench["workloads"]:
        conf = registry.config(bench, cell["config"])
        assert conf["name"] == cell["config"]
        tr = registry.traffic(cell["traffic"])
        assert hasattr(registry.loop(tr["loop"]), "Loop")
        for trace in (False, True):
            names = [m["name"] for m in registry.metrics(bench, cell["name"], trace)]
            assert names, (cell["name"], trace)
            for name in names:
                assert callable(registry.reader(name))
        assert "setup_s" in [m["name"] for m in registry.metrics(bench, cell["name"], False)]


def test_every_metric_and_config_file_exists():
    bench = registry.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(registry.HERE, "metrics", f"{m['name']}.py")), m["name"]
    for c in bench["configs"]:
        assert c["file"].startswith("port_bench/")
        assert os.path.exists(os.path.join(registry.ROOT, c["file"]))


def test_added_files_add_a_cell_and_a_metric(tmp_path):
    """A copy of the benchmark with one more traffic file, one more metric
    file and their entries: the registry finds both with no edit to any
    file that was there."""
    here = tmp_path / "port_bench"
    shutil.copytree(registry.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    bench = registry.load_benchmark()
    tr = registry.traffic("grid64")
    tr["worlds"] = 32
    (here / "traffic" / "grid32.json").write_text(json.dumps(tr))
    (here / "metrics" / "ticks_per_s.py").write_text(
        "def read(run):\n    return run['steps'] / run['window_s']\n")
    bench["workloads"].append({"name": "roach_rl6.grid32", "config": "roach_rl6",
                               "traffic": "grid32", "chips": 1, "why": "half the worlds"})
    bench["per_layer"].append({"name": "ticks_per_s", "unit": "ticks/s", "better": "higher",
                               "source": "host_clock", "layer": "closed loop",
                               "moves": "env_steps_per_s", "workloads": ["roach_rl6.grid32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b2 = registry.load_benchmark(str(tmp_path))
    assert registry.workload(b2, "roach_rl6.grid32")["traffic"] == "grid32"
    assert registry.traffic("grid32", str(here))["worlds"] == 32
    names = [m["name"] for m in registry.metrics(b2, "roach_rl6.grid32", True)]
    assert names == ["ticks_per_s"]
    assert registry.reader("ticks_per_s", str(here))({"steps": 30, "window_s": 3.0}) == 10.0
    # a metric without a workloads key is read in every cell
    assert "setup_s" in [m["name"] for m in registry.metrics(b2, "roach_rl6.grid32", False)]
