"""The port's CLI (``python -m pawsometracker_tpu_torch``) against the JAX
package's (``python -m pawsometracker_tpu``), on the CPU: the same parser plus
``--device``, byte-identical stdout for the same arguments in every mode
(``--device cpu`` on the port's side), and equal exit codes for every
argument combination that must fail loudly."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import helpers
from pawsometracker_tpu import __main__ as jax_cli
from pawsometracker_tpu_torch import __main__ as port_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TW = ["--target-width", "10"]
AT = ["--start-ij", "50", "50"]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 48-frame 100x100 FFV1 clip, and the same frames as .npy and .npz."""
    d = tmp_path_factory.mktemp("cli")
    _, tra = helpers.build_trajectory(25, 24, (50, 50), np.random.default_rng(61))
    f = helpers.trajectory2video(tra[:48], str(d), 24, 100, 100, 10, True)
    frames = np.stack([helpers.render_frame(100, 100, ij, 10, True) for ij in tra[:48]])
    np.save(str(d / "frames.npy"), frames)
    np.savez(str(d / "frames.npz"), frames=frames)
    np.savez(str(d / "bad.npz"), a=frames[:2], b=frames[:2])
    return {"f": f, "npy": str(d / "frames.npy"), "npz": str(d / "frames.npz"),
            "bad": str(d / "bad.npz")}


def run_both(capsys, argv, tmp_path=None):
    """``(rc, stdout, stderr)`` of the JAX CLI and of the port's with
    ``--device cpu``; a ``"CP"`` argument becomes each package's own
    checkpoint path under ``tmp_path``."""
    out = []
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", port_cli.main, ["--device", "cpu"])):
        rc = main([str(tmp_path / f"{name}.npz") if a == "CP" else a for a in argv] + extra)
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def test_parser_matches_jax_plus_device():
    jax_actions = {a.dest: a for a in jax_cli.build_parser()._actions}
    port_actions = {a.dest: a for a in port_cli.build_parser()._actions}
    assert set(port_actions) == set(jax_actions) | {"device"}
    for dest, want in jax_actions.items():
        got = port_actions[dest]
        assert got.option_strings == want.option_strings, dest
        assert got.default == want.default, dest
        assert got.choices == want.choices, dest
        assert got.nargs == want.nargs, dest
        assert type(got) is type(want), dest
    assert port_actions["device"].option_strings == ["--device"]
    assert port_actions["device"].default is None
    assert port_cli.build_parser().prog == "pawsometracker_tpu_torch"
    assert port_cli._window_size("21") == jax_cli._window_size("21") == 21
    assert port_cli._window_size("61x9") == jax_cli._window_size("61x9") == (61, 9)


# name: the arguments after the input(s); inputs are named by clip key
MODES = {
    "csv": (["f"], AT),
    "json": (["f"], AT + ["--format", "json"]),
    "start/stop and display xy": (["f"], ["--start", "0.5", "--stop", "1.5",
                                          "--start-xy", "50", "50"]),
    "window WxH": (["f"], AT + ["--window-size", "31x21"]),
    "window L": (["f"], AT + ["--window-size", "21"]),
    "stream roi": (["f"], AT + ["--stream", "roi", "--format", "json"]),
    "checkpoint": (["f"], AT + ["--checkpoint", "CP"]),
    "batch csv": (["f", "f"], ["--batch"] + AT),
    "batch json, mesh auto, autodetect": (["f", "npy"], ["--batch", "--mesh", "auto",
                                                         "--format", "json"]),
    "multi csv": (["f"], AT + ["--start-ij", "52", "52"]),
    "multi json n-targets": (["f"], ["--n-targets", "1", "--format", "json"]),
    "npy": (["npy"], AT + ["--format", "json"]),
    "npz at input-fps": (["npz"], AT + ["--input-fps", "48", "--format", "json"]),
    "progress": (["f"], AT + ["--progress"]),
    "batch progress": (["f", "f"], ["--batch", "--progress"] + AT),
    "multi progress": (["f"], AT + ["--start-ij", "52", "52", "--progress"]),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_stdout_matches_jax(clip, capsys, tmp_path, mode):
    inputs, rest = MODES[mode]
    argv = [clip[k] for k in inputs] + TW + rest
    (rc_j, out_j, err_j), (rc_p, out_p, err_p) = run_both(capsys, argv, tmp_path)
    assert rc_j == rc_p == 0, err_p
    assert out_p == out_j
    assert out_p.strip()
    if "CP" in rest:
        assert len(out_p.splitlines()) == 49
        assert np.load(str(tmp_path / "port.npz"))["done"]
    if "progress" in mode:
        assert err_p == err_j and " frames" in err_p


@pytest.mark.parametrize("mode", ["single", "batch", "multi"])
def test_out_npz_matches_jax(clip, capsys, tmp_path, mode):
    f = clip["f"]
    argv = {"single": [f] + AT, "batch": [f, clip["npy"], "--batch"] + AT,
            "multi": [f] + AT + ["--start-ij", "52", "52"]}[mode] + TW
    assert jax_cli.main(argv + ["--out", str(tmp_path / "j.npz")]) == 0
    assert port_cli.main(argv + ["--out", str(tmp_path / "p.npz"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ""
    with np.load(str(tmp_path / "j.npz")) as j, np.load(str(tmp_path / "p.npz")) as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            np.testing.assert_array_equal(p[k], j[k])


def test_subpixel_json_matches_jax(clip, capsys):
    """Subpixel positions agree across packages within ``atol=1e-3``."""
    argv = [clip["f"]] + AT + TW + ["--subpixel", "--format", "json"]
    (rc_j, out_j, _), (rc_p, out_p, _) = run_both(capsys, argv)
    assert rc_j == rc_p == 0
    j, p = json.loads(out_j), json.loads(out_p)
    assert p["ts"] == j["ts"]
    np.testing.assert_allclose(p["ij"], j["ij"], rtol=0, atol=1e-3)


MULTI2 = AT + ["--start-ij", "60", "60"]
# name: (inputs, arguments, the exit code both CLIs give)
FAILURES = {
    "missing file": (["/nonexistent.mp4"], [], 1),
    "start-ij with start-xy": (["f"], ["--start-ij", "1", "1", "--start-xy", "2", "2"], 2),
    "checkpoint with two files": (["f", "f"], ["--checkpoint", "CP"], 2),
    "batch with checkpoint": (["f"], ["--batch", "--checkpoint", "CP"], 2),
    "batch with n-targets": (["f"], ["--batch", "--n-targets", "2"], 2),
    "multi with checkpoint": (["f"], MULTI2 + ["--checkpoint", "CP"], 2),
    "multi with speculate contain": (["f"], MULTI2 + ["--speculate", "contain"], 2),
    "batch with speculate contain": (["f", "f"], ["--batch", "--speculate", "contain"], 2),
    "checkpoint with diagnostic file": (["f"], ["--checkpoint", "CP",
                                                "--diagnostic-file", "DIAG"], 2),
    "batch with diagnostic file": (["f", "f"], ["--batch", "--diagnostic-file", "DIAG"], 2),
    "mesh auto without batch": (["f"], ["--mesh", "auto"], 2),
    "multi with two files": (["f", "f"], MULTI2, 2),
    "ambiguous npz": (["bad"], AT + ["--format", "json"], 1),
    "start beyond the end": (["f"], AT + ["--start", "30"], 1),
    "stop before start": (["f"], AT + ["--start", "1", "--stop", "0.5"], 1),
}


@pytest.mark.parametrize("case", list(FAILURES))
def test_loud_failures_match_jax(clip, capsys, tmp_path, case):
    inputs, rest, want = FAILURES[case]
    diag = str(tmp_path / "diag.mp4")
    argv = [clip.get(k, k) for k in inputs] + [diag if a == "DIAG" else a for a in rest] + TW
    (rc_j, _, err_j), (rc_p, out_p, err_p) = run_both(capsys, argv, tmp_path)
    assert rc_j == rc_p == want
    assert "error:" in err_p and out_p == ""
    assert not (tmp_path / "port.npz").exists()


def run_module(*args, env=None):
    return subprocess.run([sys.executable, "-m", "pawsometracker_tpu_torch", *args],
                          capture_output=True, text=True, timeout=120, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})))


def test_module_help():
    r = run_module("--help")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("usage: pawsometracker_tpu_torch")
    assert "--device" in r.stdout and "--target-width" in r.stdout


def test_module_runs_on_cpu_when_asked(clip, capsys):
    argv = [clip["npy"]] + AT + TW + ["--format", "json"]
    r = run_module(*argv, "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert port_cli.main(argv + ["--device", "cpu"]) == 0
    assert r.stdout == capsys.readouterr().out
    assert len(json.loads(r.stdout)["ij"]) == 48


def test_module_without_a_card_fails_without_device(clip):
    """No card and no --device: a non-zero exit with resolve_device's
    message, never a quiet run on the CPU."""
    r = run_module(clip["npy"], *AT, *TW, env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr
    assert r.stdout == ""
