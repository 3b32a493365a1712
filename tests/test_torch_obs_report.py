"""``repro_torch.apps.obs_report``, the port's reader of the trace files
that ``repro_torch.obs`` writes, against the JAX package's reader
(``repro/apps/obs_report.py``): on the same payload the two print the
same text.  The trace comes from the port's traced ``GNNService`` on the
CPU, whose config picks land in the decision log.

The reference reader is loaded from its file under a private name, not
imported as ``repro.apps.obs_report``: its ``report(out=sys.stdout)``
binds the stream at import, and ``tests/test_obs.py`` imports it inside a
test to read it through ``capsys``, so an earlier import in the same
worker would send that test's output elsewhere."""
import importlib.util
import io
import json
import pathlib

import numpy as np
import pytest
import torch

import repro_torch.obs as tobs
from repro_torch.apps import obs_report
from repro_torch.data.graphs import rmat
from repro_torch.models.gnn import init_gcn
from repro_torch.serve import GNNService, replay, synthetic_stream

_REF = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro"
        / "apps" / "obs_report.py")


def _reference_reader():
    spec = importlib.util.spec_from_file_location("_reference_obs_report",
                                                  _REF)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SECTIONS = ("== span tree (count · total · self) ==",
            "== top 10 spans by self time ==",
            "== counters / gauges / histograms ==",
            "== decisions (")


@pytest.fixture(scope="module")
def trace_path(tmp_path_factory):
    g = rmat(9, 6, seed=2)
    feats = np.ones((g.n_rows, 8), np.float32)
    params = init_gcn([8, 8, 4], generator=torch.Generator().manual_seed(0))
    path = tmp_path_factory.mktemp("obs") / "serve.json"
    with tobs.tracing(str(path)):
        svc = GNNService(g, feats, params, device="cpu")
        replay(svc, synthetic_stream(6, g.n_rows, seed=1), tick_every=3)
    return path


def test_report_of_a_served_trace_has_four_sections(trace_path):
    assert obs_report.main([str(trace_path)]) == 0
    buf = io.StringIO()
    obs_report.report(json.loads(trace_path.read_text()), out=buf)
    out = buf.getvalue()
    at = [out.index(s) for s in SECTIONS]
    assert at == sorted(at)
    for name in ("serve.batch", "serve.pack", "serve.forward",
                 "serve_recompiles_total", "serve_requests_total"):
        assert name in out
    assert "cost_model" in out                 # the buckets' config picks


@pytest.mark.parametrize("top", [3, 10])
def test_report_text_equals_the_reference(trace_path, top):
    payload = json.loads(trace_path.read_text())
    assert payload["repro_decisions"], "no decision in the trace"
    reference = _reference_reader()
    got, want = io.StringIO(), io.StringIO()
    obs_report.report(payload, top=top, out=got)
    reference.report(payload, top=top, out=want)
    assert got.getvalue() == want.getvalue()
    # a trace of nothing: every section says it is empty, as the reference
    got, want = io.StringIO(), io.StringIO()
    obs_report.report({"traceEvents": []}, out=got)
    reference.report({"traceEvents": []}, out=want)
    assert got.getvalue() == want.getvalue()


def test_report_refuses_a_non_trace_file(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("{\"rows\": []}")
    assert obs_report.main([str(bad)]) == 1
    assert obs_report.main([str(tmp_path / "nope.json")]) == 1
    notjson = tmp_path / "trace.txt"
    notjson.write_text("not json")
    assert obs_report.main([str(notjson)]) == 1
    err = capsys.readouterr().err
    assert "not a Chrome-trace export" in err and "cannot read" in err
