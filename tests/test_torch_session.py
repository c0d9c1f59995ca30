"""The port's benchmark-job system against ``repro.core`` and
``repro.calibrate.microbench`` on the same inputs, on the CPU.

* Generated models: the four families at L = 2–4 and W = 64–256 with the
  reference's own parameters carried across by ``params_from_jax`` give the
  JAX outputs within |err| ≤ 1e-4 + 1e-4·|want| (fp32 sums taken in another
  order, and the LSTM's input products hoisted out of its time loop);
  ``flops_estimate`` and ``param_bytes`` are exactly equal.
* Microbench: ``oracle_records`` and ``fit_calibration`` equal the
  reference's (rtol 1e-12 for the least-squares solve); a measured
  ``run_calibration_job`` keeps the reference's record schema and metrics.
* Session: ``quickstart.json`` through ``BenchmarkSession`` gives the
  reference's per-job metrics inline and with concurrent followers (rtol
  1e-9; wall-clock fields aside); PerfDB and ``JobResult.to_record``
  round-trip; ``evaluate_schedulers`` and the analysis stage agree.
* What needs the card raises without one unless the CPU is asked for; plan
  jobs, ``report()``, named scenarios and tenants run as in the reference.
"""
import dataclasses
import json
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.calibrate import microbench as jmb  # noqa: E402
from repro.core import BenchmarkSession as RefSession  # noqa: E402
from repro.core import analysis as janalysis  # noqa: E402
from repro.core import generator as jgen  # noqa: E402
from repro.core import perfdb as jperfdb  # noqa: E402
from repro.core import results as jresults  # noqa: E402
from repro.core import scheduler as jscheduler  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro_torch.calibrate import kernel_bench as kb  # noqa: E402
from repro_torch.calibrate import microbench as mb  # noqa: E402
from repro_torch.core import (BenchmarkSession, CalibrationSpec,  # noqa: E402
                              ConcurrentFollowerExecutor, InlineExecutor, JobResult,
                              Leader, ModelRef, PerfDB, PlanSpec, evaluate_schedulers)
from repro_torch.core import analysis  # noqa: E402
from repro_torch.core import generator as gen  # noqa: E402
from repro_torch.core import spec as pspec  # noqa: E402
from test_torch_simulator import assert_close  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
QUICKSTART = REPO / "configs" / "jobs" / "quickstart.json"
SIZES = ((2, 64), (4, 256))
ATOL = RTOL = 1e-4
WALL = ("benchmark_wall_s", "ts")


def strip(rec):
    """A record without its wall-clock fields."""
    rec = {k: v for k, v in rec.items() if k not in WALL}
    rec["result"] = {k: v for k, v in rec["result"].items() if k != "sim_events_per_sec"}
    return rec


def jsonable(rec):
    """``rec`` as PerfDB's JSONL gives it back (tuples become lists)."""
    return json.loads(json.dumps(rec))


def ref_params(spec):
    params, fn, _ = jgen.build(jgen.GeneratedSpec(**dataclasses.asdict(spec)))
    return jax.tree.map(np.asarray, params), jax.jit(fn)


@pytest.mark.parametrize("family", gen.FAMILIES)
def test_generated_families_match_the_reference(family):
    worst = 0.0
    for layers, width in SIZES:
        spec = gen.GeneratedSpec(family, layers, width, batch=3, seq=16)
        params, fn = ref_params(spec)
        x = np.random.default_rng(layers).standard_normal(
            gen.example_inputs(spec, "cpu")[0].shape).astype(np.float32)
        want = np.asarray(fn(params, x), dtype=np.float64)
        model, _ = gen.build(spec, "cpu")
        model.load_state_dict(gen.params_from_jax(family, params))
        with torch.inference_mode():
            got = model(torch.from_numpy(x)).double().numpy()
        assert got.shape == want.shape == (3, spec.num_classes)
        err = np.abs(got - want)
        assert (err <= ATOL + RTOL * np.abs(want)).all(), (layers, width, err.max())
        worst = max(worst, float(err.max()))
        assert gen.flops_estimate(spec) == jgen.flops_estimate(jgen.GeneratedSpec(
            **dataclasses.asdict(spec)))
        assert gen.param_bytes(model) == jgen.param_bytes(params)
    print(f"{family}: max |err| {worst:.3e}")


def test_generated_weights_are_seeded_stably_and_stay_on_the_cpu_unless_asked(monkeypatch):
    spec = gen.GeneratedSpec("transformer", 2, 64)
    a, (x,) = gen.build(spec, "cpu")
    b, _ = gen.build(spec, "cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert gen.seed_of(spec.name) == gen.seed_of("transformer-L2-W64") < 2 ** 31
    assert x.dtype == torch.float32 and x.shape == (1, 64, 64)
    assert {n for n, _ in a.named_parameters()} == \
        {"w_in", "w_out", *gen.LAYER_KEYS["transformer"]}
    assert not any(p.requires_grad for p in a.parameters())
    with pytest.raises(ValueError, match="layers must hold"):
        gen.params_from_jax("lstm", {"in": 0, "out": 0, "layers": {"wx": 0}})
    with pytest.raises(ValueError):
        gen.build(gen.GeneratedSpec("rnn"), "cpu")
    def generated_job():
        session = BenchmarkSession()
        session.submit({"job_id": "g", "model": {"kind": "generated", "family": "fc",
                                                 "layers": 1, "width": 8}})
        session.run()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: gen.build(spec), lambda: gen.example_inputs(spec),
                 generated_job, lambda: mb.measured_records(CalibrationSpec(job_id="c"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_generated_job_through_the_session_on_the_cpu(tmp_path):
    job = {"job_id": "gen", "model": {"kind": "generated", "family": "lstm",
                                      "layers": 2, "width": 32, "batch_hint": 2}}
    session = BenchmarkSession(device="cpu", db=PerfDB(str(tmp_path / "db.jsonl")))
    handle = session.submit(job)
    session.run()
    got = handle.result().to_record()
    ref = RefSession()
    ref_handle = ref.submit(job)
    ref.run()
    want = ref_handle.result().to_record()
    assert got.keys() == want.keys() and got["result"].keys() == want["result"].keys()
    assert got["generated"] == want["generated"]
    assert got["result"]["mode"] == want["result"]["mode"] == "measured-cpu"
    for key in ("flops", "bytes", "intensity"):
        assert got["result"][key] == want["result"][key]
    assert got["result"]["latency_s"] > 0
    assert [strip(r) for r in PerfDB(str(tmp_path / "db.jsonl")).all()] == [jsonable(strip(got))]
    # a session of simulated jobs needs no card: device is resolved by
    # measured jobs only
    assert BenchmarkSession().device is None


def spy_on_fp32_flags(monkeypatch):
    """Make ``gen.build`` hand out models that log, at every forward, the
    fp32 precision flags they run under."""
    seen, build = [], gen.build

    def spying_build(spec, device=None):
        model, inputs = build(spec, device)
        model.register_forward_pre_hook(lambda m, args: seen.append(
            (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)))
        return model, inputs

    monkeypatch.setattr(gen, "build", spying_build)
    return seen


def test_measured_forwards_stay_ieee_fp32_whatever_the_callers_tf32(monkeypatch):
    """The generated models are fp32: the session's and the sweep's
    measured forwards run with TF32 off where the caller allows it, and the
    caller's settings come back after them."""
    from repro_torch.core.session import run_stages
    seen = spy_on_fp32_flags(monkeypatch)
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        run_stages(pspec.spec_from_dict({
            "job_id": "cnn", "model": {"kind": "generated", "family": "cnn", "layers": 1,
                                       "width": 8, "batch_hint": 1}}), device="cpu")
        n_job = len(seen)
        mb.measured_records(CalibrationSpec(
            job_id="c", model={"kind": "generated", "family": "cnn", "layers": 1,
                               "width": 8}, batches=[1, 2], repeats=1), device="cpu")
        after = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    assert 0 < n_job < len(seen) and set(seen) == {("highest", False)}
    assert after == ("high", True)


def test_ieee_fp32_blocks_may_overlap_across_threads():
    """The first block in saves the caller's flags, the last one out
    restores them, whatever the order the blocks leave in."""
    from repro_torch import ieee_fp32
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    flags = lambda: (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        first, second = ieee_fp32(), ieee_fp32()
        first.__enter__()
        second.__enter__()
        first.__exit__(None, None, None)
        inside = flags()
        second.__exit__(None, None, None)
        after = flags()
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    assert inside == ("highest", False) and after == ("high", True)


def test_oracle_records_and_fits_equal_the_reference():
    kw = dict(job_id="cal", model={"name": "gemma2-2b"}, hardware="v100", chips=2,
              batches=[1, 2, 4, 8, 16], seqs=[32, 64, 128, 256], holdout_fraction=0.25)
    spec, ref_spec = CalibrationSpec(**kw), jspec.CalibrationSpec(**kw)
    assert spec.to_dict() == ref_spec.to_dict()
    recs, ref_recs = mb.sweep_calibration(spec), jmb.sweep_calibration(ref_spec)
    assert_close(recs, ref_recs, 1e-12)
    assert_close(mb.fit_calibration(spec, recs).to_dict(),
                 jmb.fit_calibration(ref_spec, ref_recs).to_dict(), 1e-12)
    assert_close(mb.run_calibration_job(spec).metrics,
                 jmb.run_calibration_job(ref_spec).metrics, 1e-12)
    # the same measured records through both fitters
    kw = dict(job_id="m", model={"kind": "generated", "family": "lstm", "layers": 1,
                                 "width": 16}, batches=[1, 2, 4], seqs=[4, 8], repeats=1)
    measured = jmb.sweep_calibration(jspec.CalibrationSpec(**kw))
    assert_close(mb.fit_calibration(CalibrationSpec(**kw), measured).to_dict(),
                 jmb.fit_calibration(jspec.CalibrationSpec(**kw), measured).to_dict(), 1e-12)
    assert mb.resolve_mode(CalibrationSpec(job_id="r", model={"name": "gemma2-2b"},
                                           mode="measured")) == "measured"
    with pytest.raises(ValueError, match="generated model"):
        mb.measured_records(CalibrationSpec(job_id="r", model={"name": "gemma2-2b"}),
                            device="cpu")


@pytest.mark.parametrize("family,batches,seqs", [("fc", (1, 2, 4, 8), (16,)),
                                                  ("transformer", (1, 2, 4), (4, 8))])
def test_measured_calibration_job_keeps_the_reference_schema(family, batches, seqs, tmp_path):
    kw = dict(job_id=f"cal-{family}", model={"kind": "generated", "family": family,
                                             "layers": 2, "width": 32},
              batches=list(batches), seqs=list(seqs), repeats=1, holdout_fraction=0.25)
    res = mb.run_calibration_job(CalibrationSpec(**kw, profile_dir=str(tmp_path)),
                                 device="cpu")
    ref = jmb.run_calibration_job(jspec.CalibrationSpec(**kw))
    assert res.metrics.keys() == ref.metrics.keys()
    assert res.metrics["mode"] == ref.metrics["mode"] == "measured-cpu"
    assert res.metrics["n_records"] == ref.metrics["n_records"] == len(res.extra_records)
    for got, want in zip(res.extra_records, ref.extra_records):
        assert got.keys() == want.keys() and got["result"].keys() == want["result"].keys()
        assert {k: got[k] for k in got if k != "result"} == \
            {k: want[k] for k in want if k != "result"}
        assert got["result"]["mode"] == "measured-cpu" and got["result"]["latency_s"] > 0
    assert res.metrics["profile"].keys() == ref.metrics["profile"].keys()
    assert res.metrics["profile"]["grid"] == ref.metrics["profile"]["grid"]
    saved = json.loads(Path(res.metrics["profile_path"]).read_text())
    assert dict(saved, created_ts=None) == jsonable(res.metrics["profile"])
    assert res.to_record().keys() == ref.to_record().keys()


def test_calibration_kernel_hook_on_the_cpu_and_its_target():
    kw = dict(job_id="hook", model={"kind": "generated", "family": "fc", "layers": 1,
                                    "width": 16}, batches=[1, 2], seqs=[64], repeats=1,
              kernels=["int8_matmul", "rglru_scan"])
    res = mb.run_calibration_job(CalibrationSpec(**kw), device="cpu")
    kernel_recs = [r for r in res.extra_records if r.get("backend") == kb.BACKEND]
    assert res.metrics["n_kernel_records"] == len(kernel_recs) == 2 * 3
    assert res.metrics["kernels"] == ["int8_matmul", "rglru_scan"]
    assert all(r["result"]["mode"] == "reference-cpu" and r["job_id"] == "hook"
               for r in kernel_recs)
    assert sorted(res.metrics["profile"]["kernels"]) == \
        ["int8_matmul/int8", "rglru_scan/bfloat16", "rglru_scan/float32"]
    small = dict(batches=(1,), seqs=(64,), repeats=1, device="cpu")
    assert kb.kernel_records(["rglru_scan"], target="reference", **small)[0]["result"][
        "mode"] == "reference-cpu"
    with pytest.raises(RuntimeError, match="needs the card"):
        kb.kernel_records(["int8_matmul"], target="kernel", **small)
    with pytest.raises(RuntimeError, match="needs the card"):
        mb.run_calibration_job(CalibrationSpec(**dict(kw, kernel_target="kernel")),
                               device="cpu")
    with pytest.raises(ValueError, match="unknown kernel target"):
        kb.kernel_records(["int8_matmul"], target="pallas", **small)
    assert kb.resolve_target("cpu", "auto") == kb.resolve_target("cpu") == "reference"


def run_file(session_cls, path, **kw):
    session = session_cls(**kw)
    session.submit_file(path)
    return session, {r.job_id: r for r in session.run()}


def test_quickstart_through_the_session_equals_the_reference(tmp_path):
    _, want = run_file(RefSession, QUICKSTART)
    for executor in (InlineExecutor(), ConcurrentFollowerExecutor()):
        session, got = run_file(BenchmarkSession, QUICKSTART, executor=executor,
                                db=PerfDB(str(tmp_path / f"{executor.name}.jsonl")))
        assert got.keys() == want.keys() and len(got) == 18
        for job_id in want:
            assert_close(strip(got[job_id].to_record()), strip(want[job_id].to_record()),
                         1e-9, job_id)
        busy = {}
        for r in got.values():
            busy[r.schedule.worker] = max(busy.get(r.schedule.worker, 0.0),
                                          r.schedule.finish_s)
        assert {f.worker_id: f.busy_until for f in session.followers if f.executed} == busy
        # write-through PerfDB: one record per job, read back equal
        reread = PerfDB(str(tmp_path / f"{executor.name}.jsonl"))
        assert len(reread) == 18
        assert sorted(map(json.dumps, reread.all())) == \
            sorted(map(json.dumps, session.db.all()))
    db, ref_db = PerfDB(), jperfdb.PerfDB()
    for r in got.values():
        db.append(r.to_record())
        ref_db.append(want[r.job_id].to_record())
    assert analysis.leaderboard(db) == janalysis.leaderboard(ref_db)
    assert [r["job_id"] for r in analysis.recommend(db, slo_latency_s=0.05)] == \
        [r["job_id"] for r in janalysis.recommend(ref_db, slo_latency_s=0.05)]
    assert analysis.heatmap(db, row_key="chips", col_key="policy",
                            value_key="result.p99_s") == \
        janalysis.heatmap(ref_db, row_key="chips", col_key="policy",
                          value_key="result.p99_s")


def test_perfdb_and_records_round_trip(tmp_path):
    path = tmp_path / "db.jsonl"
    session = BenchmarkSession(db=PerfDB(str(path)), device="cpu")
    bench = session.submit({"job_id": "b", "model": {"name": "gemma2-2b"},
                            "workload": {"rate": 50, "duration_s": 1}})
    cal = session.submit(CalibrationSpec(job_id="c", model=ModelRef(name="granite-3-2b"),
                                         batches=(1, 2), seqs=(32, 64)))
    session.run()
    records = PerfDB(str(path)).all()
    n_extra = len(cal.result().extra_records)
    assert len(records) == 2 + n_extra == len(session.db)
    for handle in (bench, cal):
        rec = handle.result().to_record()
        back = JobResult.from_record(json.loads(json.dumps(rec)))
        assert jsonable(back.to_record()) == jsonable(rec)
        # the reference reads the port's records and writes them back equal
        ref_back = jresults.JobResult.from_record(jsonable(rec))
        assert jsonable(ref_back.to_record()) == jsonable(rec)
    # the reference's PerfDB file reads back through the port's, and back
    ref_path = tmp_path / "ref.jsonl"
    ref_db = jperfdb.PerfDB(str(ref_path))
    for rec in records:
        ref_db.append(rec)
    assert PerfDB(str(ref_path)).all() == ref_db.all() == records
    db = PerfDB(str(path))
    assert db.query(kind="calibration", phase="decode") == \
        ref_db.query(kind="calibration", phase="decode")
    assert db.distinct("job_id") == ref_db.distinct("job_id") == ["b", "c"]
    assert PerfDB.get_path(records[0], "result.mode") == \
        jperfdb.PerfDB.get_path(records[0], "result.mode")


def test_schedulers_equal_the_reference():
    for seed in (0, 3):
        assert evaluate_schedulers(n_workers=4, n_jobs=60, seed=seed) == \
            jscheduler.evaluate_schedulers(n_workers=4, n_jobs=60, seed=seed)


def test_leader_shim_and_what_waits_for_the_next_slice(tmp_path):
    """The leader shim runs a job, and what waited for the planner and the
    scenario library's copy runs as in the reference: a plan job gives the
    reference's metrics (rtol 1e-9), ``report()`` writes the reference's
    HTML for the session's records, a named scenario resolves and a plan's
    tenants are accepted as the reference's."""
    from repro.obs.report import render_report as ref_render_report
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        leader = Leader(n_workers=2)
    leader.submit(pspec.BenchmarkJobSpec(job_id="l", workload={"rate": 20, "duration_s": 1}))
    assert [r["job_id"] for r in leader.run_all()] == ["l"]
    plan = dict(job_id="p", profile="gemma2-2b@tpu-v5e",
                profile_dir=str(REPO / "configs" / "profiles"),
                workload={"rate": 40, "duration_s": 2, "seed": 3}, replicas=(1, 2))
    session = BenchmarkSession()
    session.submit(PlanSpec(**plan))
    ref = RefSession()
    ref.submit(jspec.PlanSpec(**plan))
    (got,), (want,) = session.run(), ref.run()
    assert got.metrics["candidates"] == 4
    assert_close(strip(jsonable(got.to_record())), strip(jsonable(want.to_record())), 1e-9)
    path = tmp_path / "r.html"
    assert session.report(str(path)) == str(path)
    assert path.read_text() == ref_render_report([got.to_record()])
    scenario = pspec.BenchmarkJobSpec(job_id="s", scenario="chat")
    assert scenario.slo_ttft_s == 0.5 and scenario.workload.prefix_tokens == 192
    assert jsonable(scenario.to_dict()) == jsonable(
        jspec.BenchmarkJobSpec(job_id="s", scenario="chat").to_dict())
    tenants = ({"name": "a", "share": 1.0},)
    assert jsonable(PlanSpec(job_id="t", profile="x", tenants=tenants).to_dict()) == \
        jsonable(jspec.PlanSpec(job_id="t", profile="x", tenants=tenants).to_dict())


PORTED = ("core/perfdb.py", "hw.py", "models/registry.py", "serving/latency_model.py",
          "obs/spec.py", "obs/recorder.py", "configs/shapes.py", "analysis/memory_model.py",
          "serving/memory.py", "serving/simulator.py", "serving/cluster.py",
          "core/analysis.py", "core/spec.py", "core/results.py", "core/generator.py",
          "calibrate/microbench.py", "core/scheduler.py", "core/session.py",
          "core/leader.py", "scenarios/__init__.py", "scenarios/profiles.py",
          "scenarios/arrivals.py", "scenarios/synth.py", "scenarios/tenants.py",
          "calibrate/planner.py", "obs/timeline.py", "obs/report.py")


def test_the_slice_keeps_the_reference_module_names():
    """Each module of this slice sits under the reference's name (the import
    checks of tests/test_torch_serving.py walk every file of the port)."""
    for rel in PORTED:
        assert (REPO / "src" / "repro_torch" / rel).is_file(), rel
        assert (REPO / "src" / "repro" / rel).is_file(), rel

