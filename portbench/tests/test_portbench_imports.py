"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level names (``pawsometracker_tpu_torch`` is not ``pawsometracker_tpu``),
and the reference loads nothing of the program."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BANNED = {"jax", "jaxlib", "flax", "pawsometracker_tpu"}


def top_names_after(code: str) -> set:
    prog = (code + "\nimport json, sys\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={k: v for k, v in os.environ.items()
                                         if k != "PYTHONPATH"})
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax():
    names = top_names_after(
        "import runpy, sys; sys.path.insert(0, '.'); runpy.run_path('portbench/run.py');"
        "import portbench.reference, portbench.harness, portbench.control, portbench.trace;"
        "import pawsometracker_tpu_torch, pawsometracker_tpu_torch.batch;"
        "from portbench import frames; [frames.load_module(k, f[:-3]) for k in "
        "('metrics', 'entries') for f in __import__('os').listdir('portbench/' + k)]")
    assert "pawsometracker_tpu_torch" in names  # the check compares whole names
    assert not names & BANNED, names & BANNED


def test_the_reference_loads_nothing_of_the_program():
    names = top_names_after("import sys; sys.path.insert(0, '.'); import portbench.reference;"
                            "import portbench.reference.tracker, portbench.reference.multi")
    assert not names & (BANNED | {"pawsometracker_tpu_torch", "torch"})


def test_the_harness_reports_a_banned_module_by_its_whole_name(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "pawsometracker_tpu_torch_extra", object())
    assert "pawsometracker_tpu" not in harness.banned_modules() or \
        "pawsometracker_tpu" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in harness.banned_modules()


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    prog = ("import sys; sys.path.insert(0, '.'); from portbench import harness;"
            "harness.run('track-roi-1080', 1, 1, False, device='cpu')")
    r = subprocess.run([sys.executable, "-c", prog], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode != 0 and r.stdout == ""
    assert "pawsometracker_tpu_torch" in r.stderr
