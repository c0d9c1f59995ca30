"""The port's cells, dry-run and report against the JAX package's.

``launch/cells.py`` must give the reference's ``mem_info`` (parameter,
optimizer-state and cache bytes, batch and vocabulary terms) and
``model_flops`` for every family and kind of step, against the reference's
``build_cell`` on a one-device mesh (shapes only: ``jax.eval_shape``).  The
mesh's axes are ``Auto``: ``make_host_mesh``'s default ``Explicit`` axes
make the reference's ``with_sharding_constraint`` refuse its prefill step
under this JAX.  The counted FLOPs are held to the reference's
``cost_analysis()`` and to ``model_flops`` within the ratios stated below;
``launch/dryrun.py`` writes the reference's records, which the reference's
report reads; ``analysis/report.py`` gives the reference's table and picks.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402
from repro.analysis import report as ref_report  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.shapes import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.launch import cells as ref_cells  # noqa: E402
from repro.launch import costing as ref_costing  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro_torch.analysis import report  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.launch import cells, costing, dryrun, roofline_report  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402

FAMILIES = {"gemma2-2b": {"num_layers": 7}, "granite-moe-3b-a800m": {"num_layers": 3},
            "recurrentgemma-9b": {"num_layers": 11}, "rwkv6-7b": {"num_layers": 3},
            "whisper-tiny": {"num_layers": 3, "encoder_layers": 3},
            "llava-next-34b": {"num_layers": 3}}
KINDS = ("train", "prefill", "decode")
S, B = 64, 8
BUILD = {"train": cells.build_train_cell, "prefill": cells.build_prefill_cell,
         "decode": cells.build_decode_cell}
REF_BUILD = {"train": ref_cells.build_train_cell, "prefill": ref_cells.build_prefill_cell,
             "decode": ref_cells.build_decode_cell}


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _cells(arch, kind, mesh, **cfg_kw):
    kw = {**FAMILIES[arch], **cfg_kw}
    ours = BUILD[kind](arch, ShapeSpec("cell", S, B, kind), cfg=reduced(get_config(arch), **kw))
    ref_cfg = ref_reduced(ref_get_config(arch), **kw)
    theirs = REF_BUILD[kind](arch, RefShapeSpec("cell", S, B, kind), mesh, cfg=ref_cfg)
    return ours, theirs


# Our count is the matmul-like ops and each kernel's formula (4·d a live
# pair and head for attention, causal pairs only); XLA's cost_analysis also
# counts every elementwise op and attention's full S × S logits.  So ours
# is below it, by about a fifth at these widths.
XLA_RATIO = (0.7, 1.0)


@pytest.mark.parametrize("arch", ["gemma2-2b", "rwkv6-7b"])
def test_prefill_flops_against_reference_cost_analysis(arch, mesh):
    ours, _ = _cells(arch, "prefill", mesh)
    # the reference's cost config: every scan unrolled, so XLA counts each layer
    _, theirs = _cells(arch, "prefill", mesh, cost_unroll=True)
    with mesh:
        want = ref_costing.extract_costs(theirs.lower().compile())["flops"]
    ratio = costing.count_costs(ours.fn, *ours.args)["flops"] / want
    assert XLA_RATIO[0] <= ratio <= XLA_RATIO[1]


# counted FLOPs / model_flops (6·N·tokens train, 2·N·tokens serve, N without
# the embeddings, MoE experts at k/E): train recomputes the forward under
# remat (8N against 6N: 4/3), less the hybrid's elementwise gate and conv
# parameters, plus attention and the loss head; prefill adds attention and
# the MoE's capacity factor (1.25); decode attends the whole cache.  Two
# decode steps differ from 2·N by construction: whisper-tiny's runs no
# encoder, whose parameters N counts; granite-moe-3b-a800m's computes every
# expert (E/k = 2 here) for its few tokens.
MODEL_RATIO = {"train": (1.3, 1.9), "prefill": (1.0, 1.3), "decode": (1.0, 1.4),
               ("whisper-tiny", "decode"): (0.7, 1.0),
               ("granite-moe-3b-a800m", "decode"): (3.0, 4.0)}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_cell_matches_reference_and_counts_model_flops(arch, kind, mesh):
    ours, theirs = _cells(arch, kind, mesh)
    assert ours.mem_info == theirs.mem_info
    assert (ours.model_flops, ours.tokens) == (theirs.model_flops, theirs.tokens)
    lo, hi = MODEL_RATIO.get((arch, kind), MODEL_RATIO[kind])
    ratio = costing.count_costs(ours.fn, *ours.args)["flops"] / ours.model_flops
    assert lo <= ratio <= hi


def test_rules_and_meshes_other_than_one_device_raise(tmp_path):
    """Rules other than one device's need a mesh: a cell given rules and no
    mesh, and the one-device dry-run (``--mesh one``, the default) given
    rules, raise and write nothing (the production meshes take every rule
    set: tests/test_torch_sharding.py)."""
    with pytest.raises(ValueError, match="mesh"):
        cells.build_cell("gemma2-2b", "decode_32k", rules=object())
    for argv in (["--rules", "tp"], ["--mesh", "one", "--rules", "ep_local"]):
        with pytest.raises(ValueError, match="production mesh"):
            dryrun.main(argv + ["--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_dryrun_writes_records_the_reference_report_reads(tmp_path, capsys):
    out = tmp_path / "dryrun"
    dryrun.main(["--arch", "gemma2-2b", "--shape", "decode_32k", "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[OK] gemma2-2b__decode_32k__single")
    assert lines[-1] == "dry-run complete: 1 ok, 0 failed"
    assert dryrun.run_cell("gemma2-2b", "long_500k")["skipped"]
    recs = report.load_cells(str(out))
    assert recs == ref_report.load_cells(str(out))
    ok = recs[0]
    assert ok["mesh"] == "1" and ok["cost_depths"] == [2, 4, 13]
    assert set(ok) == {"arch", "shape", "mesh", "rules", "ok", "lower_s", "compile_s",
                       "tokens", "memory", "production_costs_scan_body_once", "roofline",
                       "cost_depths"}
    assert set(ok["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                 "alias_bytes", "peak_bytes"}
    # the port's layers are a loop: the full-depth run counts what the two
    # depths extrapolate to
    prod, r = ok["production_costs_scan_body_once"], ok["roofline"]
    assert (prod["flops"], prod["bytes"]) == (r["flops_per_device"], r["bytes_per_device"])
    # the decode step updates the cache in place: outputs alias operands
    assert 0 < ok["memory"]["alias_bytes"] <= ok["memory"]["output_bytes"]
    assert ok["memory"]["argument_bytes"] <= ok["memory"]["peak_bytes"]
    assert "gemma2-2b" in roofline_report.report(str(out)).splitlines()[1]


def _records(seed):
    """Seeded dry-run-shaped records: OK cells, a skip and a failure."""
    rng = np.random.default_rng(seed)
    recs = []
    for arch in ("gemma2-2b", "yi-9b", "granite-8b", "rwkv6-7b"):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            terms = {k: float(rng.uniform(1e-4, 10)) for k in
                     ("compute_s", "memory_s", "memory_s_hlo", "collective_s")}
            step = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
            recs.append({"arch": arch, "shape": shape, "ok": True,
                         "memory": {"peak_bytes": int(rng.integers(1, 2 ** 40))},
                         "roofline": {**terms, "step_time_s": step,
                                      "dominant": str(rng.choice(["compute", "memory"])),
                                      "useful_ratio": float(rng.uniform(0, 1)),
                                      "model_flops_util": float(rng.uniform(0, 1))}})
    recs.append({"arch": "yi-9b", "shape": "long_500k", "ok": True, "skipped": True})
    recs.append({"arch": "dbrx-132b", "shape": "train_4k", "ok": False})
    return recs


@pytest.mark.parametrize("seed", range(3))
def test_roofline_table_and_picks_match_reference(seed):
    recs = _records(seed)
    assert report.roofline_table(recs) == ref_report.roofline_table(recs)
    assert report.pick_hillclimb_cells(recs) == ref_report.pick_hillclimb_cells(recs)


def test_load_cells_matches_reference(tmp_path):
    for rec in _records(0):
        name = f"{rec['arch']}__{rec['shape']}__single.json"
        (tmp_path / name).write_text(json.dumps(rec))
    (tmp_path / "gemma2-2b__decode_32k__single__tp.json").write_text("{}")
    assert report.load_cells(str(tmp_path)) == ref_report.load_cells(str(tmp_path))
    assert report.load_cells(str(tmp_path), rules="tp") == \
        ref_report.load_cells(str(tmp_path), rules="tp")
