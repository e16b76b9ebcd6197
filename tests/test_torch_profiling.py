"""The port's timers and trace (``phifem_tpu_torch.utils.profiling``): the
``Timer`` phases and report format of the JAX package's, ``report_throughput``
as JAX's, and ``device_trace`` writing a Chrome trace on the CPU (a no-op for
a falsy ``logdir``)."""

import json
import os
import time

import pytest
import torch

from phifem_tpu_torch.utils import Timer, device_trace, report_throughput


def test_timer_phases_accumulate_and_report():
    t = Timer(device="cpu")
    with t.phase("setup"):
        time.sleep(0.01)
    with t.phase("solve"):
        pass
    with t.phase("setup"):
        time.sleep(0.01)
    assert list(t.phases) == ["setup", "solve"]
    assert t.phases["setup"] >= 0.02 and t.phases["solve"] >= 0.0
    lines = t.report().split("\n")
    assert lines[0] == f"{'setup':>24s}: {t.phases['setup']:8.3f} s"
    assert lines[1] == f"{'solve':>24s}: {t.phases['solve']:8.3f} s"
    assert lines[2] == f"{'total':>24s}: {sum(t.phases.values()):8.3f} s"


def test_timer_report_matches_jax_format():
    pytest.importorskip("jax")
    from phifem_tpu.utils import Timer as JTimer

    j, t = JTimer(), Timer(device="cpu")
    j.phases = {"tag+setup": 0.0123, "assemble": 1.5, "solve": 12.25}
    t.phases = dict(j.phases)
    assert t.report() == j.report()


def test_timer_phase_records_on_error():
    t = Timer(device="cpu")
    with pytest.raises(RuntimeError):
        with t.phase("boom"):
            raise RuntimeError("x")
    assert "boom" in t.phases


def test_timer_defaults_to_the_card():
    t = Timer()
    assert t.device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            with t.phase("x"):
                pass


def test_report_throughput(capsys):
    assert report_throughput(2_000_000, 0.5) == 4.0
    assert capsys.readouterr().out == ""
    assert report_throughput(1_000_000, 0.25, label="s1") == 4.0
    assert capsys.readouterr().out == "s1: 1000000 DoF in 0.2500 s = 4.00 MDoF/s\n"
    assert report_throughput(10, 0.0) == float("inf")


def test_report_throughput_matches_jax(capsys):
    pytest.importorskip("jax")
    from phifem_tpu.utils import report_throughput as jreport

    a = jreport(123456, 0.789, label="x")
    ja = capsys.readouterr().out
    b = report_throughput(123456, 0.789, label="x")
    assert (a, ja) == (b, capsys.readouterr().out)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with device_trace(str(logdir)) as path:
        x = torch.arange(1000.0)
        (x * x).sum()
    assert os.path.dirname(path) == str(logdir) and os.path.isfile(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mul" in e.get("name", "") for e in events)


@pytest.mark.parametrize("logdir", [None, ""])
def test_device_trace_is_a_noop_without_logdir(tmp_path, logdir):
    before = set(os.listdir(tmp_path))
    with device_trace(logdir) as path:
        torch.ones(3).sum()
    assert path is None and set(os.listdir(tmp_path)) == before
