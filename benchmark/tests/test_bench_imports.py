"""The import guard: nothing the harness runs loads JAX or the JAX
package, compared by whole top-level names (the port's name begins with
the JAX package's), and the reference loads nothing of the port."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
TESTS = pathlib.Path(__file__).resolve().parent


def _loaded(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({n.split('.')[0] for n, m in "
         "sys.modules.items() if m is not None})))"],
        cwd=ROOT, env={"PYTHONPATH": f"{ROOT}:{TESTS}", "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _loaded("import benchmark.run\n"
                    "from conftest import CELLS, run_tiny\n"
                    "for c in CELLS:\n"
                    "    assert run_tiny(c, trace=True)['correct']\n"
                    "from benchmark import harness\n"
                    "assert not harness.forbidden_modules()")
    assert not names & {"jax", "jaxlib", "flax", "imageencoder_tpu"}
    assert "imageencoder_tpu_torch" in names  # the port ran


def test_guard_blocks_before_anything_else():
    names = _loaded("import benchmark.run\n"
                    "try:\n    import jax\nexcept ImportError:\n    pass\n"
                    "else:\n    raise SystemExit('jax imported')\n"
                    "try:\n    import imageencoder_tpu\n"
                    "except ImportError:\n    pass\n"
                    "else:\n    raise SystemExit('the JAX package imported')")
    assert "imageencoder_tpu" not in names


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from benchmark import harness

    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "imageencoder_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", None)  # blocked
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "imageencoder_tpu.models", sys)
    assert harness.forbidden_modules() == sorted(
        before + ["imageencoder_tpu.models"])


def test_reference_loads_nothing_of_the_port():
    names = _loaded("import benchmark.reference.codec\n"
                    "import benchmark.content, benchmark.roofline")
    assert not names & {"imageencoder_tpu_torch", "imageencoder_tpu",
                        "jax"}
