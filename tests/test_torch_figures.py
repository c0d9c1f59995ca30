"""The port's Fig. 9 and Fig. 10 (``launch/figures.py``) against the
reference's suites (``benchmarks/bench_sensitivity.py``,
``benchmarks/bench_roofline.py``) on the CPU.

Both must emit the same ``name,us_per_call,derived`` rows, by name, and
write JSON of the same keys: Fig. 9's heat maps over the same cut grid,
Fig. 10's (a) entries from the same dry-run records with the same
intensities and attained FLOP/s (the roofline bound is read against the
H100's ridge in the port, the TPU v5e's in the reference), (b) the same
points with the same intensities.  Times differ, and are not compared.
The reference's models are not timed here (their ``MeasuredLatency`` is
replaced by a constant): only its keys and its arithmetic on the records
are wanted.
"""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import benchmarks.bench_roofline as ref_roofline  # noqa: E402
import benchmarks.bench_sensitivity as ref_sensitivity  # noqa: E402
import benchmarks.common as ref_common  # noqa: E402
from repro_torch.launch import dryrun, figures  # noqa: E402


class _Untimed:
    def __init__(self, fn, **kw):
        pass

    def measure(self, *args):
        return 1e-3


@pytest.fixture
def reference(monkeypatch, tmp_path):
    monkeypatch.setattr(ref_common, "OUT_DIR", tmp_path / "reference")
    for mod in (ref_roofline, ref_sensitivity):
        monkeypatch.setattr(mod, "MeasuredLatency", _Untimed)
    # Fig. 9 at a cut grid, the same in both
    for mod in (ref_sensitivity, figures):
        monkeypatch.setattr(mod, "LAYERS", (2, 4))
        monkeypatch.setattr(mod, "WIDTHS", (128,))
    return tmp_path / "reference"


def _rows(out: str):
    return [line.split(",")[0] for line in out.splitlines() if line.startswith("fig")]


def test_fig9_matches_reference(reference, tmp_path, capsys):
    ref_sensitivity.run()
    want_rows = _rows(capsys.readouterr().out)
    maps = figures.fig9(str(tmp_path), device="cpu")
    assert _rows(capsys.readouterr().out) == want_rows
    want = json.loads((reference / "fig9_sensitivity.json").read_text())
    got = json.loads((tmp_path / "fig9_sensitivity.json").read_text())
    assert got == json.loads(json.dumps(maps))
    assert set(got) == set(want)
    for key, hm in got.items():
        assert set(hm) == set(want[key])
        assert {k: hm[k] for k in ("rows", "cols", "row_key", "col_key", "value_key")} == \
            {k: want[key][k] for k in ("rows", "cols", "row_key", "col_key", "value_key")}
        assert all(v > 0 for row in hm["matrix"] for v in row)


def test_fig10_matches_reference(reference, monkeypatch, tmp_path, capsys):
    records = tmp_path / "dryrun"
    records.mkdir()
    for shape in ("decode_32k", "prefill_32k", "long_500k"):
        (records / f"whisper-tiny__{shape}__single.json").write_text(
            json.dumps(dryrun.run_cell("whisper-tiny", shape)))
    monkeypatch.setattr(ref_roofline, "DRYRUN_DIR", records)
    capsys.readouterr()
    ref_roofline.run()
    want_rows = _rows(capsys.readouterr().out)
    figures.fig10(str(tmp_path / "port"), str(records), device="cpu")
    assert _rows(capsys.readouterr().out) == want_rows
    want = json.loads((reference / "fig10_roofline.json").read_text())
    got = json.loads((tmp_path / "port" / "fig10_roofline.json").read_text())
    assert set(got) == set(want) == {"real", "generated"}
    assert set(got["real"]) == set(want["real"]) == {"whisper-tiny/decode_32k",
                                                     "whisper-tiny/prefill_32k"}
    for key, entry in got["real"].items():
        assert set(entry) == set(want["real"][key])
        for k in ("intensity", "attained_tflops", "dominant_term"):
            assert entry[k] == want["real"][key][k]
    assert set(got["generated"]) == set(want["generated"])
    for key, pt in got["generated"].items():
        assert set(pt) == set(want["generated"][key])
        assert pt["intensity"] == pytest.approx(want["generated"][key]["intensity"], rel=1e-12)


def test_figures_need_a_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: figures.fig9(str(tmp_path)),
                lambda: figures.fig10(str(tmp_path), str(tmp_path)),
                lambda: figures.main(["fig9", "--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
    assert not list(tmp_path.iterdir())
