"""The port's serving layer against the reference, and the port's isolation.

Greedy generation on converted weights must give the JAX engine's token ids;
``run_server`` must return the reference's result keys; the copied workload
generator must give the reference's request streams, those of the scenario
library's kinds and tenant splits included.  The port must import
neither JAX nor anything of ``repro``, and must refuse to run without a card
unless the CPU was asked for.
"""
import dataclasses
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.launch.serve import run_server as ref_run_server  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.serving import engine as ref_engine  # noqa: E402
from repro.serving import workload as ref_workload  # noqa: E402
from repro.serving.batching import make_policy as ref_make_policy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import run_server  # noqa: E402
from repro_torch.models import DecoderLM, build_model, reduced  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.batching import make_policy  # noqa: E402
from repro_torch.serving.engine import make_generate_fn  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def test_greedy_tokens_match_reference_engine():
    """Reduced gemma2-2b, 8 greedy steps on a cache as long as the padded
    prompt (the reference's default), so the longest sequence wraps it."""
    ref_model = ref_build_model(ref_reduced(REF_ARCHS["gemma2-2b"]))
    ref_params = ref_model.init(jax.random.key(0))
    model = build_model(reduced(get_config("gemma2-2b")), "cpu")
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), model)
    toks = np.random.default_rng(3).integers(0, 256, (2, 64)).astype(np.int32)
    lengths = np.array([63, 55], np.int32)
    want = jax.jit(ref_engine.make_generate_fn(ref_model, 8))(
        ref_params, toks, lengths)
    got = make_generate_fn(model, 8)(params, torch.from_numpy(toks),
                                     torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_run_server_returns_reference_keys():
    wl = dict(rate=20.0, duration_s=0.2, prompt_tokens=8, seed=0)
    want = ref_run_server(ref_reduced(REF_ARCHS["granite-3-2b"]),
                          ref_make_policy("none"), ref_workload.WorkloadSpec(**wl),
                          max_len=16, decode_steps=4)
    got = run_server(reduced(get_config("granite-3-2b")), make_policy("none"),
                     workload.WorkloadSpec(**wl), max_len=16, decode_steps=4,
                     device="cpu")
    assert list(got) == list(want)
    assert got["requests"] == want["requests"] == len(
        workload.generate(workload.WorkloadSpec(**wl)))
    assert all(np.isfinite(v) for v in got.values())


SPECS = [
    dict(kind="poisson", rate=30.0, duration_s=5.0),
    dict(kind="poisson", rate=12.0, duration_s=4.0, prompt_tokens=64,
         prompt_tokens_max=512, output_tokens=4, output_tokens_max=32,
         prefix_tokens=16),
    dict(kind="uniform", rate=25.0, duration_s=2.0),
    dict(kind="burst", rate=10.0, duration_s=6.0, burst_factor=8.0),
    dict(kind="ramp", duration_s=5.0, ramp_min_rate=5.0, ramp_max_rate=40.0,
         ramp_steps=4, output_tokens_max=None),
    dict(kind="closed", concurrency=5, duration_s=3.0),
    dict(kind="trace", trace_path=str(REPO / "configs" / "traces" / "seed_chat.jsonl")),
]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s["kind"])
def test_workload_stream_matches_reference(spec, seed):
    got = workload.generate(workload.WorkloadSpec(seed=seed, **spec))
    want = ref_workload.generate(ref_workload.WorkloadSpec(seed=seed, **spec))
    assert len(got) > 0
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]


@pytest.mark.parametrize("spec", [dict(kind="diurnal"), dict(kind="flash-crowd"),
                                  dict(kind="sweep"),
                                  dict(tenants=({"name": "a", "share": 1.0},))])
def test_scenario_workloads_wait_for_the_scenario_copy(spec):
    """The kinds and the tenant split that waited for the scenario library's
    copy give the reference's request stream, request for request."""
    got = workload.generate(workload.WorkloadSpec(**spec))
    want = ref_workload.generate(ref_workload.WorkloadSpec(**spec))
    assert len(got) > 0
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]


def test_port_imports_without_jax():
    """Every module of the port imports with JAX made unimportable."""
    mods = sorted(".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import sys; sys.modules['jax'] = None; import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules), 'repro imported'\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


# an import of jax or repro: a statement (also in a list, ``import os,
# repro``), or a module named by a string (importlib, __import__)
IMPORT = re.compile(r"^\s*(import\s+([\w.]+(\s+as\s+\w+)?\s*,\s*)*(jax|repro)\b(?!_)"
                    r"|from\s+(jax|repro)(\.|\s)(?!_))"
                    r"|(import_module|__import__)\(\s*[\'\"](jax|repro)[.\'\"]", re.M)


def test_the_import_guard_sees_every_form():
    caught = ["import repro", "import repro.kernels.ref as r", "    import jax.numpy as jnp",
              "from repro.models import build_model", "from jax import numpy",
              "import os, repro", "import numpy as np, jax",
              "importlib.import_module('repro.kernels')", '__import__("jax")']
    passed = ["import repro_torch", "from repro_torch.kernels import wkv6",
              "import os, repro_torch", "importlib.import_module('repro_torch.models')",
              "# the reference (repro) differentiates with jax"]
    assert [bool(IMPORT.search(line)) for line in caught] == [True] * len(caught)
    assert [bool(IMPORT.search(line)) for line in passed] == [False] * len(passed)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + sorted((REPO / "examples_torch").glob("*.py"))
                         + [REPO / "chip_smoke.py", REPO / "parity_probe.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_neither_jax_nor_reference(path):
    assert not IMPORT.findall(path.read_text())


def test_the_import_guard_covers_the_distribution_modules():
    scanned = set(PORT.rglob("*.py"))
    assert {PORT / "dist" / "__init__.py", PORT / "dist" / "sharding.py",
            PORT / "launch" / "mesh.py"} <= scanned


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("gemma2-2b"))
    for make in (lambda: DecoderLM(cfg), lambda: build_model(cfg),
                 lambda: run_server(cfg, make_policy("none"),
                                    workload.WorkloadSpec(duration_s=0.1))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert DecoderLM(cfg, "cpu").device.type == "cpu"
