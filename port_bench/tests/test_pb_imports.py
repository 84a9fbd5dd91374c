"""The import guard: nothing under port_bench/ reaches jax, jaxlib, flax
or the JAX package (thinktwice_tpu), and nothing under
port_bench/reference/ reaches the port (thinktwice_tpu_torch) either.
Modules are compared by their top-level name whole, since the port's name
begins with the JAX package's."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from port_bench import registry

JAX = {"jax", "jaxlib", "flax", "thinktwice_tpu"}
PORT = "thinktwice_tpu_torch"


def _sources(sub: str = ""):
    top = os.path.join(registry.HERE, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path: str) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_names_jax_or_the_jax_package():
    for path in _sources():
        assert not _imported(path) & JAX, path


def test_no_reference_source_names_the_port():
    for path in _sources("reference"):
        assert PORT not in _imported(path), path


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=registry.ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_and_loops_load_no_jax():
    """Every module of the harness and its loops, and the port modules the
    loops import, loaded in one interpreter: no JAX top-level name."""
    code = ("import port_bench.run, port_bench.harness, port_bench.calibrate\n"
            "import port_bench.loops.roach, port_bench.loops.student\n"
            "import thinktwice_tpu_torch.agents.expert, thinktwice_tpu_torch.agents.thinktwice_driver\n"
            "import thinktwice_tpu_torch.train.loop, thinktwice_tpu_torch.rollout\n"
            "import port_bench.reference.roach_check, port_bench.reference.student_check\n")
    loaded = _loaded(code)
    assert not loaded & JAX, loaded & JAX
    assert PORT in loaded


def test_reference_loads_not_the_port():
    code = ("import port_bench.reference.roach_check, port_bench.reference.student_check\n"
            "import port_bench.reference.ttref.weights\n")
    loaded = _loaded(code)
    assert PORT not in loaded
    assert not loaded & JAX


def test_run_refuses_a_loaded_jax_package():
    """run.py's check after the window names a forbidden module by its whole
    top-level name."""
    code = ("import sys, types\nsys.modules['thinktwice_tpu'] = types.ModuleType('thinktwice_tpu')\n"
            "import port_bench.run as r\nassert r.forbidden_modules() == ['thinktwice_tpu'], "
            "r.forbidden_modules()\ndel sys.modules['thinktwice_tpu']\n"
            "import thinktwice_tpu_torch\nassert r.forbidden_modules() == []\n")
    _loaded(code)
