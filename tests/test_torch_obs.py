"""The port's span timeline and HTML run report against ``repro.obs`` on the
same inputs, on the CPU.

* ``build_trace``: one workload through both packages' simulators with the
  observability layer on gives the reference's Chrome trace within rtol 1e-9
  (two simulators in two packages; timestamps in µs), with tenants, with
  sampled traces and with a disaggregated cluster; ``request_stage_spans``
  likewise per request; ``write_trace`` writes JSON that loads back.
* ``render_report`` is pure formatting: given the same records it returns the
  reference's HTML byte for byte — the port's records and the reference's,
  with time series, a sampling warning, a plan job and the baseline table.
* The report CLI (``python -m repro_torch.obs.report``) writes the
  reference's file for the same PerfDB file and baseline.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import run_stages as ref_run_stages  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import timeline as jtimeline  # noqa: E402
from repro.obs.spec import ObsSpec as RefObsSpec  # noqa: E402
from repro_torch.core import run_stages  # noqa: E402
from repro_torch.core import spec as pspec  # noqa: E402
from repro_torch.obs import ObsSpec, build_trace, render_report, write_report  # noqa: E402
from repro_torch.obs import report, timeline  # noqa: E402
from test_torch_scenarios import PORT, REF, TENANTS, simulate  # noqa: E402
from test_torch_simulator import assert_close  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
BASELINE = REPO / "benchmarks" / "baselines" / "ci_baseline.json"
RTOL_SIM = 1e-9
FLASH = dict(kind="flash-crowd", rate=150.0, duration_s=4.0, burst_factor=10.0,
             output_tokens=16, seed=7)
RUNS = {   # workload, and the cluster's and simulate_cluster's keywords
    "flash": (FLASH, {}),
    "tenants": (dict(rate=20.0, duration_s=6.0, seed=7, tenants=TENANTS), {}),
    "sampled": (FLASH, {"trace_sample": 0.25}),
    "disaggregated": (dict(rate=60.0, duration_s=3.0, prompt_tokens=64,
                           prompt_tokens_max=2048, output_tokens=2, output_tokens_max=8,
                           seed=6),
                      {"disaggregation": {"prefill_replicas": 1, "decode_replicas": 1,
                                          "prefill_max_batch": 4}}),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_build_trace_equals_the_reference(run, tmp_path):
    spec, kw = RUNS[run]
    res = simulate(PORT, spec, obs=ObsSpec(), **kw)
    ref = simulate(REF, spec, obs=RefObsSpec(), **kw)
    got = build_trace(res, title=run, max_requests=0)
    want = jtimeline.build_trace(ref, title=run, max_requests=0)
    assert_close(got, want, RTOL_SIM, "trace")
    names = {e["name"] for e in got["traceEvents"] if e["ph"] == "X"}
    assert {"queue", "prefill", "decode"} <= names
    assert any(e["tid"] == 0 for e in got["traceEvents"] if e["ph"] == "X"), "engine lanes"
    if run == "sampled":
        assert got["metadata"]["sampling_rate"] < 1.0
    if run == "disaggregated":
        assert "kv_transfer" in names
    for tr, ref_tr in zip(res.traces, ref.traces):
        assert_close(timeline.request_stage_spans(tr), jtimeline.request_stage_spans(ref_tr),
                     RTOL_SIM, f"req {tr.request.req_id}")
    capped = build_trace(res, max_requests=5)
    assert_close(capped, jtimeline.build_trace(ref, max_requests=5), RTOL_SIM, "capped")
    path = timeline.write_trace(res, str(tmp_path / "trace.json"), title=run)
    assert json.loads(Path(path).read_text()) == json.loads(json.dumps(got))


OBS_JOB = dict(job_id="obs-e2e", model={"name": "gemma2-2b"}, chips=4,
               workload={"kind": "flash-crowd", "rate": 60, "duration_s": 3,
                         "burst_factor": 5.0, "output_tokens": 8, "seed": 7},
               cluster={"replicas": 2}, obs={})
PLAN_JOB = dict(job_id="plan", profile="gemma2-2b@tpu-v5e",
                profile_dir=str(REPO / "configs" / "profiles"),
                workload={"rate": 40, "duration_s": 2, "seed": 3}, replicas=(1, 2))


def records(pkg_spec, pkg_run_stages):
    """PerfDB records of a job with a time series, a sampled job and a plan."""
    jobs = [pkg_spec.BenchmarkJobSpec(**OBS_JOB),
            pkg_spec.BenchmarkJobSpec(**dict(OBS_JOB, job_id="plain", obs=None)),
            pkg_spec.PlanSpec(**PLAN_JOB)]
    recs = [json.loads(json.dumps(pkg_run_stages(j).to_record())) for j in jobs]
    recs[1]["result"]["sampling_rate"] = 0.1
    return recs


@pytest.mark.parametrize("source", ["port", "reference"])
def test_render_report_is_the_reference_html_byte_for_byte(source, tmp_path):
    recs = records(pspec, run_stages) if source == "port" else records(jspec, ref_run_stages)
    baseline = json.loads(BASELINE.read_text())
    bench = {"cluster": {"ramp": {"continuous": {"throughput_rps": 123.0}}}}
    for kw in ({}, {"title": "flash crowd"}, {"baseline": baseline, "bench_inputs": bench}):
        html = render_report(recs, **kw)
        assert html == jreport.render_report(recs, **kw)
    assert "<svg" in html and "Baseline deltas" in html and "sampl" in html
    path = write_report(recs, str(tmp_path / "sub" / "r.html"), title="t")
    assert Path(path).read_text() == jreport.render_report(recs, title="t")
    series = [("a", [0.0, 1.0, 2.0], [1.0, 3.0, 2.0]), ("b", [0.5, 2.5], [0.0, 4.0])]
    assert report.svg_chart("c", series, y_unit="s") == \
        jreport.svg_chart("c", series, y_unit="s")


def test_report_cli_writes_the_reference_file(tmp_path, capsys):
    recs = records(pspec, run_stages)
    db = tmp_path / "perf.jsonl"
    db.write_text("".join(json.dumps(r) + "\n" for r in recs))
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps({"ramp": {"continuous": {"throughput_rps": 99.0}}}))
    args = [str(db), "--title", "run", "--baseline", str(BASELINE),
            "--bench", f"cluster={bench}"]
    assert report.main(args + ["-o", str(tmp_path / "port.html")]) == 0
    assert jreport.main(args + ["-o", str(tmp_path / "ref.html")]) == 0
    assert (tmp_path / "port.html").read_text() == (tmp_path / "ref.html").read_text()
    assert report.load_records(str(db)) == jreport.load_records(str(db)) == recs
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace("port.html", "ref.html") == lines[1]
    # as a module, in its own process
    out = tmp_path / "m.html"
    subprocess.run([sys.executable, "-W", "error::RuntimeWarning", "-m",
                    "repro_torch.obs.report", *args, "-o", str(out)],
                   check=True, cwd=tmp_path, capture_output=True,
                   env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert out.read_text() == (tmp_path / "ref.html").read_text()
