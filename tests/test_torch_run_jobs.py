"""The port's job-config launcher (``python -m repro_torch.launch.run_jobs``)
against the reference's ``benchmarks/run.py --config`` on the CPU.

Every committed ``configs/jobs/*.json`` runs through both from one temporary
working directory that holds a copy of ``configs/`` (the configs' relative
paths — a calibration's ``profile_dir``, a plan's ``configs/profiles`` —
resolve there, and nothing is written into the repo), with the inline
executor and with concurrent followers.  Each job's PerfDB records must be
within rtol 1e-9 of the reference's (two simulators in two packages;
wall-clock fields aside), and the printed leaderboard and recommendations
must be the reference's: line for line with the inline executor, and up to
the order of tied rows with concurrent followers, whose completion order
sets the order of ties in PerfDB.
"""
import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from benchmarks.run import run_config as ref_run_config  # noqa: E402
from repro_torch.launch import run_jobs  # noqa: E402
from test_torch_simulator import assert_close  # noqa: E402

CONFIGS = sorted(p.name for p in (REPO / "configs" / "jobs").glob("*.json"))
WALL = ("benchmark_wall_s", "ts")
RTOL_SIM = 1e-9


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    shutil.copytree(REPO / "configs", tmp_path / "configs")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def by_job(path: Path) -> dict:
    """A PerfDB file's records per job id, without wall-clock fields."""
    out = {}
    for line in path.read_text().splitlines():
        rec = {k: v for k, v in json.loads(line).items() if k not in WALL}
        rec["result"] = {k: v for k, v in rec["result"].items()
                         if k != "sim_events_per_sec"}
        out.setdefault(rec["job_id"], []).append(rec)
    return out


def table(out: str) -> list:
    """The printed lines but the run's wall time and the PerfDB path."""
    return [line for line in out.splitlines()
            if not line.startswith(("# executed", "# PerfDB records appended"))]


def test_all_seven_configs_are_covered():
    assert CONFIGS == ["calibrate_plan.json", "cluster.json", "disaggregated.json",
                       "memory_pressure.json", "mixed_fleet.json", "multi_tenant.json",
                       "quickstart.json"]


@pytest.mark.parametrize("executor", ["inline", "concurrent"])
@pytest.mark.parametrize("config", CONFIGS)
def test_config_runs_as_in_the_reference(config, executor, workdir, capsys):
    path = f"configs/jobs/{config}"
    assert run_jobs.main(["--config", path, "--executor", executor,
                          "--db", "port.jsonl", "--device", "cpu"]) == 0
    got_out = capsys.readouterr().out
    ref_run_config(argparse.Namespace(config=path, executor=executor, workers=4,
                                      db="ref.jsonl"))
    want_out = capsys.readouterr().out
    got, want = by_job(workdir / "port.jsonl"), by_job(workdir / "ref.jsonl")
    assert sorted(got) == sorted(want) and got
    for job_id in want:
        assert_close(got[job_id], want[job_id], RTOL_SIM, job_id)
    if executor == "inline":
        assert table(got_out) == table(want_out)
    else:
        assert sorted(table(got_out)) == sorted(table(want_out))
    if config == "calibrate_plan.json":
        # the calibration's relative profile_dir resolves in the working dir
        assert (workdir / "experiments" / "bench" / "profiles"
                / "gemma2-2b__tpu-v5e.json").is_file()
        (plan,) = got["plan-gemma2"]
        assert plan["result"]["best"] is not None


def test_launcher_as_a_module(workdir):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.run_jobs", "--config",
         "configs/jobs/multi_tenant.json", "--device", "cpu", "--executor", "inline"],
        cwd=workdir, capture_output=True, text=True, check=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.stdout.startswith("# 2 jobs from configs/jobs/multi_tenant.json "
                                  "(inline executor, 4 followers)")
    assert "mt-bench" in proc.stdout


def test_measured_jobs_need_the_card_unless_cpu_is_asked(workdir, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = workdir / "gen.json"
    cfg.write_text(json.dumps({"jobs": [{
        "job_id": "gen", "model": {"kind": "generated", "family": "fc", "layers": 1,
                                   "width": 16}}]}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_jobs.main(["--config", str(cfg), "--executor", "inline"])
    assert run_jobs.main(["--config", str(cfg), "--executor", "inline",
                          "--device", "cpu"]) == 0
    assert "gen" in capsys.readouterr().out
