"""The port's two example flows that execute a model (``examples_torch/``):
``serve_benchmark`` and ``train_100m``, against the reference's
(``examples/``) on the CPU.

serve_benchmark: with ``run_server`` replaced by the same stub in both, the
reference and the port print the same table, byte for byte, and hand the
stub the same config, policies, workload and cache length; then the port
serves, for real with ``device="cpu"``, the reference's request count under
each policy, none one request a batch.  (On the card it serves gemma2-2b at
full width: ``chip_smoke.py`` phase 22 (a).)

train_100m: with both ``train.main``s replaced by a recorder, the port
hands its trainer the reference's argument list, for no overrides and for
``--steps 30``, but for the checkpoint directory, which is its own."""
from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import sys
import tempfile

import pytest
import torch

import repro.launch.serve as ref_serve
import repro.launch.train as ref_train
from repro.serving import workload as ref_workload
from repro_torch.launch import train as port_train
from test_torch_examples_sim import cs, reference_run


port_example = cs.example


def run_reference(name: str, args: list) -> str:
    """The stdout of ``examples/<name>.py`` run in-process with ``args``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        reference_run(name, args)()
    return out.getvalue()


class StubServer:
    """Records each ``run_server`` call and answers with numbers that depend
    on the policy alone."""

    def __init__(self):
        self.calls = []

    def __call__(self, cfg, policy, workload, *, max_len, decode_steps, device=None):
        self.calls.append(dict(cfg=cfg, policy=policy, workload=workload,
                               max_len=max_len, decode_steps=decode_steps))
        k = len(self.calls)
        return {"requests": 100 + k, "throughput_rps": 10.25 * k, "p50_s": 0.0125 * k,
                "p99_s": 0.0375 * k, "mean_batch": 1.0 + 0.5 * (k - 1),
                "mean_infer_s": 0.01 * k}


def fields(obj) -> dict:
    """A config's or a policy's settings, by name."""
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return {"class": type(obj).__name__, **vars(obj)}


def test_serve_benchmark_prints_the_reference_table_on_its_inputs(monkeypatch):
    ref_stub, port_stub = StubServer(), StubServer()
    monkeypatch.setattr(ref_serve, "run_server", ref_stub)
    want = run_reference("serve_benchmark", [])
    sb = port_example("serve_benchmark")
    monkeypatch.setattr(sb, "run_server", port_stub)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = sb.main(["--device", "cpu"])
    assert out.getvalue() == want
    assert [p.name for p, _ in rows] == ["none", "tfs-window", "tris-preferred"]
    assert len(port_stub.calls) == len(ref_stub.calls) == 3
    for got, ref in zip(port_stub.calls, ref_stub.calls):
        ref_cfg = fields(ref["cfg"])
        assert {k: v for k, v in fields(got["cfg"]).items() if k in ref_cfg} == ref_cfg
        assert fields(got["policy"]) == fields(ref["policy"])
        assert dataclasses.asdict(got["workload"]) == dataclasses.asdict(ref["workload"])
        assert (got["max_len"], got["decode_steps"]) == (ref["max_len"], ref["decode_steps"])


def test_serve_benchmark_on_the_card_is_gemma2_2b_at_full_width():
    from repro_torch.configs import get_config
    sb = port_example("serve_benchmark")
    cfg, full = sb.model_config("cuda"), get_config("gemma2-2b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
            cfg.vocab_size) == (26, full.d_model, full.num_heads, full.num_kv_heads,
                                full.d_ff, full.vocab_size)
    assert str(cfg.param_dtype) in ("bfloat16", "torch.bfloat16")
    assert sb.MAX_LEN >= sb.BASE.workload.prompt_tokens + sb.DECODE_STEPS


def test_serve_benchmark_serves_the_reference_request_count_on_the_cpu():
    sb = port_example("serve_benchmark")
    # The workload arrives in real time: one intra-op thread keeps each
    # batch short when the suite's other workers share the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rows = sb.main(["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    spec = sb.BASE.workload
    n = len(ref_workload.generate(ref_workload.WorkloadSpec(**dataclasses.asdict(spec))))
    assert n > 100
    assert [res["requests"] for _, res in rows] == [n] * 3
    assert rows[0][1]["mean_batch"] == 1.0
    assert all(res["mean_batch"] > 1.0 for _, res in rows[1:])


@pytest.mark.parametrize("args", [[], ["--steps", "30"], ["--steps", "30", "--layers", "2"]],
                         ids=["defaults", "steps", "steps-and-a-new-flag"])
def test_train_100m_hands_the_trainer_the_reference_arguments(args, monkeypatch):
    got, want = [], []
    monkeypatch.setattr(ref_train, "main", lambda: want.append(sys.argv[1:]))
    monkeypatch.setattr(port_train, "main", got.append)
    run_reference("train_100m", args)
    monkeypatch.setattr(sys, "argv", ["train_100m.py"] + args)
    port_example("train_100m").main()
    (got,), (want,) = got, want
    at = want.index("--ckpt-dir") + 1
    assert got.index("--ckpt-dir") + 1 == at
    assert got[:at] + got[at + 1:] == want[:at] + want[at + 1:]
    # its own checkpoint directory, never the reference's
    assert got[at] != want[at]
    assert got[at] == os.path.join(tempfile.gettempdir(), "repro_torch_100m_ckpt")
    assert port_example("train_100m").arguments(args) == got
