"""``REPRO_TRACE`` in the port: a process whose environment names a trace
file traces from the import of ``repro_torch.obs`` to its exit, as the
reference's ``repro.obs`` does (``tests/test_obs.py::test_env_autostart``).
"""
import json
import pathlib
import subprocess
import sys

from repro_torch import obs
from repro_torch.obs import trace as obs_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_env_autostart(tmp_path, monkeypatch):
    path = tmp_path / "env.json"
    monkeypatch.setenv("REPRO_TRACE", str(path))
    obs_trace._env_autostart()
    assert obs.trace_enabled()
    obs.instant("from_env")
    assert obs.stop_tracing() == str(path)   # atexit re-run is a no-op
    payload = json.loads(path.read_text())
    assert any(e["name"] == "from_env" for e in payload["traceEvents"])


def test_env_autostart_is_off_without_the_variable(monkeypatch):
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    obs_trace._env_autostart()
    assert not obs.trace_enabled()


def test_repro_trace_traces_a_process_to_its_exit(tmp_path):
    path = tmp_path / "t.json"
    code = ("from repro_torch import obs\n"
            "assert obs.trace_enabled()\n"
            "with obs.span('train.step', step=0):\n"
            "    pass\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "REPRO_TRACE": str(path)},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in events if e["ph"] == "X"] == ["train.step"]
