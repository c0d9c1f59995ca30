"""The port's example flows that run on the host (``examples_torch/``)
against the reference's (``examples/``), and a guard that the port is
complete.

Each reference flow runs in-process from a temporary working directory
(``configs/`` linked in, so profiles resolve and written files land there);
its live stdout must equal its golden text in tests/golden_torch_examples/,
and the port's flow must print the same golden, byte for byte.  The files
observe_flash_crowd writes must have the SHA-256 that flows.json records,
from both.  ``chip_smoke.py`` phase 22 (b) holds the port to these goldens on
the card's host, which has no JAX.

One exception to byte equality, named in ``chip_smoke.UNORDERED_ROWS``:
quickstart's followers run concurrently, and rows that tie on a table's sort
key land in completion order (in the reference as in the port), so in its
tables each run of rows that print the same but for the job id is compared
as a multiset (``chip_smoke.settled``); every other row keeps its place."""
from __future__ import annotations

import importlib.util
import runpy
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "src" / "repro"
PORT = REPO / "src" / "repro_torch"
# The one reference module without a counterpart in the port, and why.
NO_COUNTERPART = {
    "analysis/hlo.py": "it parses XLA HLO text, which the port has none of; its one job, "
                       "the collective bytes of the roofline, is launch/costing.py's count "
                       "of the _c10d_functional collectives DTensor issues"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()
FLOWS = cs.golden_flows()


def reference_run(name: str, args: list):
    """A callable that runs ``examples/<name>.py`` in-process with ``args``
    as its command line."""
    path = REPO / "examples" / f"{name}.py"

    def run():
        argv = sys.argv
        sys.argv = [str(path)] + args
        try:
            runpy.run_path(str(path), run_name="__main__")
        finally:
            sys.argv = argv
    return run


@pytest.mark.parametrize("side", ["reference", "port"])
@pytest.mark.parametrize("case", sorted(FLOWS))
def test_flow_prints_its_golden(case, side, tmp_path):
    flow = FLOWS[case]
    workdir = cs.flow_dir(tmp_path)
    if side == "reference":
        run = reference_run(flow["flow"], flow["args"])
    else:
        main = cs.example(flow["flow"]).main
        run = lambda: main(flow["args"])  # noqa: E731
    got, want = cs.against_golden(case, cs.flow_output(run, workdir))
    assert got == want
    assert {f: cs.sha256(workdir / f) for f in flow.get("files", {})} == flow.get("files", {})


def lines_swapped(text: str, a: str, b: str) -> str:
    """``text`` with the line that starts with ``a`` and the one that starts
    with ``b`` in each other's place."""
    lines = text.split("\n")
    i, j = (next(n for n, line in enumerate(lines) if line.lstrip().startswith(w + " "))
            for w in (a, b))
    lines[i], lines[j] = lines[j], lines[i]
    return "\n".join(lines)


@pytest.mark.parametrize("a, b, tied", [
    ("api-job", "quickstart-14", True),         # one spec: the same result
    ("quickstart-4", "api-job", False),         # both print 492
    ("quickstart-8", "quickstart-12", False),   # both print 491.7
    ("quickstart-2", "quickstart-10", False),
    ("quickstart-12", "quickstart-6", False),   # the top-3, both $0.0019
    ("quickstart-6", "quickstart-0", False),
])
def test_only_tied_rows_may_change_places(a, b, tied):
    text = (cs.GOLDEN / "quickstart.txt").read_text()
    swapped = lines_swapped(text, a, b)
    assert swapped != text
    got, want = cs.against_golden("quickstart", swapped)
    assert (got == want) is tied
    if tied:
        cs.held_to_golden("quickstart", swapped)
    else:
        with pytest.raises(RuntimeError, match="quickstart differs from its golden"):
            cs.held_to_golden("quickstart", swapped)


def test_settled_sorts_runs_equal_but_for_the_first_word():
    text = "head\n\nT x\nb 1 2\na 1 2\nc 1 3\n\nU\nz\ny"
    assert cs.settled(text) == "head\n\nT x\na 1 2\nb 1 2\nc 1 3\n\nU\nz\ny"


@pytest.mark.parametrize("case", ["scheduler_casestudy", "capacity_plan"])
def test_a_line_off_the_golden_fails_the_phase(case):
    text = (cs.GOLDEN / f"{case}.txt").read_text()
    cs.held_to_golden(case, text)
    digit = next(i for i, c in enumerate(text) if c.isdigit())
    moved = text[:digit] + str((int(text[digit]) + 1) % 10) + text[digit + 1:]
    with pytest.raises(RuntimeError, match=f"{case} differs from its golden"):
        cs.held_to_golden(case, moved)
    with pytest.raises(RuntimeError, match=f"{case} differs from its golden"):
        cs.held_to_golden(case, text + "more\n")


def test_every_reference_module_has_its_counterpart_in_the_port():
    missing = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")
                     if not (PORT / p.relative_to(REF)).exists())
    assert missing == sorted(NO_COUNTERPART)


def test_every_reference_example_has_its_counterpart():
    ref = sorted(p.name for p in (REPO / "examples").glob("*.py"))
    assert len(ref) == 12
    assert sorted(p.name for p in cs.EXAMPLES.glob("*.py")) == ref


def test_the_goldens_cover_every_host_flow():
    executed = {"serve_benchmark", "train_100m"}   # tests/test_torch_examples_exec.py
    host = {p.stem for p in (REPO / "examples").glob("*.py")} - executed
    assert {flow["flow"] for flow in FLOWS.values()} == host
    assert sorted(p.stem for p in cs.GOLDEN.glob("*.txt")) == sorted(FLOWS)
