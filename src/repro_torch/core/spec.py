"""Benchmark job specification — the paper's "a YAML file with a few lines".

A ``BenchmarkJobSpec`` fully describes one benchmark task: which model
(a registered arch or a generated canonical model), which hardware tier,
which serving-software tier (batching policy + runtime options), which
workload, and which metrics/SLO to evaluate.  ``SweepSpec`` expands the
cross-product the way the paper's system iterates configurations.

A copy of ``repro.core.spec``, importing only ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

from repro_torch.obs.spec import ObsSpec
from repro_torch.serving.cluster import ClusterSpec, DisaggSpec
from repro_torch.serving.memory import MemorySpec
from repro_torch.serving.workload import WorkloadSpec


def _load_config_data(path: Union[str, Path]) -> Dict[str, Any]:
    """Parse a JSON or TOML config file into a plain dict."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".toml":
        try:
            import tomllib
        except ImportError:
            try:
                import tomli as tomllib  # type: ignore[no-redef]
            except ImportError as e:  # pragma: no cover - env without tomli
                raise RuntimeError(
                    "TOML configs need Python 3.11+ (tomllib) or the tomli "
                    f"package; rewrite {path} as JSON instead") from e
        with path.open("rb") as f:
            return tomllib.load(f)
    if suffix == ".json":
        return json.loads(path.read_text())
    raise ValueError(f"unsupported config format {suffix!r} for {path} "
                     "(expected .json or .toml)")


@dataclasses.dataclass(frozen=True)
class ModelRef:
    kind: str = "registered"        # registered | generated
    name: str = "gemma2-2b"         # arch id, or generated family
    # generated-model hyper-parameters (paper's canonical generator):
    family: str = "transformer"     # fc | cnn | lstm | transformer
    layers: int = 4
    width: int = 256
    batch_hint: int = 1

    @property
    def label(self) -> str:
        """Stable display/profile key: the arch id, or the generated
        model's canonical ``family-Ln-Wm`` name."""
        if self.kind == "generated":
            return f"{self.family}-L{self.layers}-W{self.width}"
        return self.name


@dataclasses.dataclass(frozen=True)
class SoftwareSpec:
    """Serving-software tier: batching policy + runtime options.

    Attributes:
        policy: batching scheduler — ``none`` | ``tfs`` | ``tris`` |
            ``continuous`` (Orca-style continuous batching).
        max_batch: batch-window cap (tfs/tris) or continuous-batching
            decode slots per replica (requests).
        timeout_s: batch-window wait timeout (seconds).
        preferred: preferred batch sizes, largest first (tris policy).
        max_prefill: continuous batching — prefills admitted per engine
            iteration (requests).
        int8: the paper's INT8-conversion step (legacy boolean; prefer
            ``speed_mode="int8"``).
        use_pallas_kernels: the reference's switch between its Pallas
            kernels and pure-jnp refs; kept for the schema (no stage
            reads it, here or in the reference).
        speed_mode: named serving :class:`~repro_torch.serving.latency_model.
            SpeedMode` ("fp16" | "int8" | "speculative") applied to the
            latency oracle; None = vanilla fp16.
    """
    policy: str = "tris"            # none | tfs | tris | continuous
    max_batch: int = 8              # window cap / continuous decode slots
    timeout_s: float = 0.005
    preferred: Sequence[int] = (8, 4, 2, 1)
    max_prefill: int = 8            # continuous: joins per iteration
    int8: bool = False              # the paper's INT8-conversion step
    use_pallas_kernels: bool = True
    speed_mode: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class BenchmarkJobSpec:
    """One fully-specified benchmark task (the paper's YAML job).

    Attributes:
        job_id: unique submission id (string, user-chosen).
        user: submitting user (display/bookkeeping only).
        model: the :class:`ModelRef` under test.
        hardware: hardware-tier key in ``repro_torch.hw.HARDWARE``.
        chips: accelerator chips per replica (weights/KV sharded).
        software: serving :class:`SoftwareSpec` (policy + options).
        workload: request-arrival :class:`WorkloadSpec`.
        cluster: multi-replica :class:`ClusterSpec` (routing, scaling).
        network: client-side network model key (``lan`` | ``wifi`` |
            ``4g`` | ...), see ``repro_torch.serving.latency_model.NETWORKS``.
        scenario: named production scenario filling workload/SLO
            defaults (``repro_torch.scenarios.profiles``); explicit fields win.
        slo_latency_s: end-to-end request latency SLO (seconds), or
            None for no latency SLO.
        slo_ttft_s: time-to-first-token SLO (seconds); enables goodput.
        slo_tpot_s: time-per-output-token SLO (seconds/token).
        metrics: metric groups to evaluate (names, e.g. "latency").
        est_processing_s: scheduler runtime hint (seconds).
        profile: calibrated-profile ref (JSON path or
            ``model@hardware``) replacing the analytic oracle.
        obs: observability opt-in (:class:`~repro_torch.obs.spec.ObsSpec`);
            None = fast path with aggregate metrics only.
    """
    job_id: str
    user: str = "dev"
    model: ModelRef = ModelRef()
    hardware: str = "tpu-v5e"
    chips: int = 8
    software: SoftwareSpec = SoftwareSpec()
    workload: WorkloadSpec = WorkloadSpec()
    cluster: ClusterSpec = ClusterSpec()
    network: str = "lan"
    # named production scenario (repro_torch.scenarios.profiles): one config
    # line — {"scenario": "chat"} — fills the workload's token/session
    # distributions and the job's SLOs with the profile's values;
    # explicitly-set fields always win over the profile
    scenario: Optional[str] = None
    slo_latency_s: Optional[float] = None
    # phase SLOs (the TTFT/TPOT language LLM deployments are judged by):
    # when either is set, results gain goodput_rps + phase_slo_attainment
    # (requests meeting every provided SLO jointly)
    slo_ttft_s: Optional[float] = None
    slo_tpot_s: Optional[float] = None
    metrics: Sequence[str] = ("latency", "throughput", "cost", "utilization")
    est_processing_s: float = 1.0   # scheduler hint (paper: known a priori)
    # calibrated oracle: profile JSON path or "model@hardware" key — when
    # set, serving is clocked by the fitted profile instead of the
    # analytic roofline model (hardware/chips then come from the profile)
    profile: Optional[str] = None
    # observability layer (repro_torch.obs): time-series recorder + span
    # timeline for this job's simulation.  Merged into the cluster spec;
    # an ObsSpec already set there wins.  None (default) = fast path.
    obs: Optional[ObsSpec] = None

    def __post_init__(self):
        # accept plain dicts for the nested specs (declarative construction)
        coercions = (("model", ModelRef), ("software", SoftwareSpec),
                     ("workload", WorkloadSpec), ("cluster", ClusterSpec))
        for field, cls in coercions:
            val = getattr(self, field)
            if isinstance(val, dict):
                d = dict(val)
                if cls is SoftwareSpec and isinstance(d.get("preferred"),
                                                      list):
                    d["preferred"] = tuple(d["preferred"])
                object.__setattr__(self, field, cls(**d))
        if isinstance(self.obs, dict):
            object.__setattr__(self, "obs", ObsSpec.from_dict(self.obs))
        if self.obs is not None and self.cluster.obs is None:
            # job-level opt-in rides into the simulation via the cluster
            # spec (idempotent: a round-tripped spec re-merges to itself)
            object.__setattr__(self, "cluster",
                               dataclasses.replace(self.cluster,
                                                   obs=self.obs))
        if self.scenario:
            # resolve the named profile: fill workload fields left at
            # their defaults, and adopt the profile's SLOs where the job
            # declares none (idempotent, so to_dict → from_dict round
            # trips are stable)
            from repro_torch.scenarios.profiles import get_profile
            prof = get_profile(self.scenario)
            object.__setattr__(self, "workload",
                               prof.apply_to_workload(self.workload))
            for slo_field, default in prof.slos().items():
                if default is not None \
                        and getattr(self, slo_field) is None:
                    object.__setattr__(self, slo_field, default)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BenchmarkJobSpec":
        d = dict(d)
        # nested dicts (model/software/workload/cluster) are coerced to
        # their spec types by __post_init__
        if isinstance(d.get("metrics"), list):
            d["metrics"] = tuple(d["metrics"])
        return cls(**d)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "BenchmarkJobSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_file(cls, path: Union[str, Path]) -> "BenchmarkJobSpec":
        """One job from a JSON/TOML file (use ``load_jobs`` for sweeps)."""
        data = _load_config_data(path)
        if "base" in data or "jobs" in data:
            raise ValueError(
                f"{path} holds a sweep/job-list config; load it with "
                "repro_torch.core.spec.load_jobs or BenchmarkSession.submit_file")
        return cls.from_dict(data)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Cross-product expansion (the paper's automatic iteration)."""
    base: BenchmarkJobSpec
    axes: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"base": self.base.to_dict(), "axes": dict(self.axes)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SweepSpec":
        base = d["base"]
        if isinstance(base, dict):
            base = BenchmarkJobSpec.from_dict(base)
        return cls(base=base, axes=dict(d.get("axes", {})))

    @classmethod
    def from_file(cls, path: Union[str, Path]) -> "SweepSpec":
        return cls.from_dict(_load_config_data(path))

    def expand(self) -> Iterator[BenchmarkJobSpec]:
        keys = list(self.axes)
        for i, combo in enumerate(itertools.product(
                *(self.axes[k] for k in keys))):
            d = self.base.to_dict()
            for k, v in zip(keys, combo):
                node = d
                *path, leaf = k.split(".")
                for p in path:
                    node = node[p]
                node[leaf] = v
            d["job_id"] = f"{self.base.job_id}-{i}"
            yield BenchmarkJobSpec.from_dict(d)


# ---- calibration + capacity planning (repro_torch.calibrate) ---------------------
@dataclasses.dataclass(frozen=True)
class CalibrationSpec:
    """A microbenchmark sweep → fitted latency profile (measure → model).

    Generated models (``model.kind == "generated"``) are executed for
    real on the device per grid point; registered archs are swept through the
    kernel-validated analytic roofline oracle.  The resulting records
    land in PerfDB under ``kind="calibration"`` and the least-squares
    fit is persisted as a named profile when ``profile_dir`` is set.

    Attributes:
        job_id: unique submission id.
        user: submitting user.
        model: the :class:`ModelRef` to calibrate.
        hardware: hardware-tier key in ``repro_torch.hw.HARDWARE``.
        chips: chips per replica the fit is valid for.
        batches: batch sizes swept (requests per step).
        seqs: prefill prompt lengths swept (tokens).
        contexts: decode KV context lengths swept (tokens); empty
            means reuse ``seqs``.
        mode: ``auto`` | ``measured`` (wall-clock on the device) | ``oracle``
            (analytic roofline).
        repeats: measured-mode timing iterations per grid point
            (min-of-N per pass, two passes).
        holdout_fraction: fraction of grid points held out to score
            fit generalization (0 disables).
        profile_dir: directory the fitted profile JSON is saved to
            (None = don't persist).
        kernels: Hopper kernels to microbench alongside the model
            sweep (``repro_torch.calibrate.kernel_bench`` registry names;
            empty = skip).  Their per-kernel fits + derived speed
            modes ride into the profile.
        kernel_target: what the kernel sweep clocks — ``auto``
            (kernel on the card, reference on the CPU) | ``kernel``
            (the card only) | ``reference``.
        est_processing_s: scheduler runtime hint (seconds).
    """
    job_id: str
    user: str = "dev"
    model: ModelRef = ModelRef(kind="generated", family="fc",
                               layers=2, width=64)
    hardware: str = "cpu-xeon"
    chips: int = 1
    batches: Sequence[int] = (1, 2, 4, 8)
    seqs: Sequence[int] = (16, 32, 64, 128)
    contexts: Sequence[int] = ()        # decode KV lengths; () → ``seqs``
    mode: str = "auto"                  # auto | measured | oracle
    repeats: int = 10                   # measured-mode timing iterations
                                        # (min-of-N per pass, two passes)
    holdout_fraction: float = 0.25      # grid points held out for validation
    profile_dir: Optional[str] = None   # save the fitted profile JSON here
    kernels: Sequence[str] = ()         # Hopper kernels to microbench too
    kernel_target: str = "auto"         # auto | kernel | reference
    est_processing_s: float = 1.0       # scheduler hint

    kind = "calibration"

    def __post_init__(self):
        if isinstance(self.model, dict):
            object.__setattr__(self, "model", ModelRef(**self.model))
        for field in ("batches", "seqs", "contexts", "kernels"):
            val = getattr(self, field)
            if isinstance(val, list):
                object.__setattr__(self, field, tuple(val))

    def to_dict(self) -> Dict[str, Any]:
        return dict(dataclasses.asdict(self), kind=self.kind)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CalibrationSpec":
        d = dict(d)
        d.pop("kind", None)
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """An SLO-aware capacity-planning job (model → plan).

    Loads a calibration profile (path or ``model@hardware`` key), drives
    the cluster simulator over a replicas × batching-policy × router
    grid, and reports the cheapest configuration whose SLO attainment
    meets ``slo_target``.

    Attributes:
        job_id: unique submission id.
        profile: calibration-profile ref — JSON path or
            ``model@hardware`` key resolved in ``profile_dir``.
        user: submitting user.
        profile_dir: directory ``model@hardware`` keys resolve in.
        workload: aggregate request-arrival :class:`WorkloadSpec`.
        tenants: multi-tenant split (TenantSpec list/dicts); the plan
            then requires every tenant's own SLOs at ``slo_target``.
        slo_latency_s: end-to-end latency SLO (seconds); None = only
            phase SLOs apply.
        slo_target: required attainment fraction in [0, 1].
        ttft_slo_s: time-to-first-token SLO (seconds).
        tpot_slo_s: time-per-output-token SLO (seconds/token).
        replicas: replica counts searched.
        policies: batching policies searched.
        routers: router kinds searched.
        max_batch: decode-slot cap used when ``max_batches`` is empty
            (requests).
        max_batches: decode-slot grid (requests); empty =
            ``(max_batch,)``.
        max_prefill: prefill admissions per engine iteration.
        prefill_decode_splits: disaggregated (prefill, decode) replica
            splits added to the grid.
        kv_network: interconnect for the disaggregated KV handoff.
        network: client network model key.
        objective: SLO-feasible candidates are ranked by this summary
            metric (e.g. ``cost_per_1k_req``, USD per 1000 requests).
        speed_modes: serving speed modes searched ("fp16" | "int8" |
            "speculative" names, or SpeedMode parameter dicts); empty =
            fp16 only.  Calibrated parameters in the profile's
            ``speed_modes`` section override the named presets.
        memory: per-replica HBM budget
            (:class:`~repro_torch.serving.memory.MemorySpec`); candidates
            whose KV working set cannot fit are rejected up front.
        fleets: heterogeneous fleet compositions added to the grid —
            each entry is a list of ``PoolSpec`` dicts (hardware,
            replicas, pricing, region, ...), simulated under every
            policy/router/slot combination so the plan can recommend a
            device mix or a spot-backed fleet on the objective.
        est_processing_s: scheduler runtime hint (seconds).
    """
    job_id: str
    profile: str                         # profile path or model@hardware key
    user: str = "dev"
    profile_dir: str = "configs/profiles"
    workload: WorkloadSpec = WorkloadSpec()
    # multi-tenant mix: TenantSpec list (or dicts) splitting the
    # workload's aggregate rate — the plan then requires *every*
    # tenant's own SLOs at slo_target (see repro_torch.scenarios.tenants)
    tenants: Sequence[Any] = ()
    slo_latency_s: Optional[float] = 0.25
    slo_target: float = 0.99             # required attainment fraction
    # phase SLOs: attainment becomes joint over every SLO provided (set
    # slo_latency_s to None to plan on TTFT/TPOT alone)
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None
    replicas: Sequence[int] = (1, 2, 4)
    policies: Sequence[str] = ("tfs", "continuous")
    routers: Sequence[str] = ("least-loaded",)
    max_batch: int = 16
    max_batches: Sequence[int] = ()      # grid over decode slots; () →
                                         # (max_batch,)
    max_prefill: int = 8
    # disaggregation axis: (prefill, decode) replica splits added to the
    # search grid as split-pool candidates (KV handoff over kv_network)
    prefill_decode_splits: Sequence[Sequence[int]] = ()
    kv_network: str = "infiniband"
    network: str = "lan"
    objective: str = "cost_per_1k_req"   # minimized among SLO-feasible
    # serving speed modes searched alongside the hardware/software grid;
    # names resolve through the profile's calibrated ``speed_modes``
    # section first, then the built-in presets
    speed_modes: Sequence[Any] = ()
    # KV-cache awareness: when set, candidates whose working set exceeds
    # the per-replica HBM budget are rejected up front (with the reason),
    # and feasible candidates are simulated under that budget.  Fitted
    # profiles carry no model config, so set hbm_gb + kv_bytes_per_token.
    memory: Optional[MemorySpec] = None
    # fleet-composition axis: sequences of PoolSpec dicts (heterogeneous
    # hardware / spot / regions) searched beside the flat-replica grid
    fleets: Sequence[Any] = ()
    est_processing_s: float = 1.0        # scheduler hint

    kind = "plan"

    def __post_init__(self):
        if isinstance(self.workload, dict):
            object.__setattr__(self, "workload",
                               WorkloadSpec(**self.workload))
        if isinstance(self.memory, dict):
            object.__setattr__(self, "memory",
                               MemorySpec.from_dict(self.memory))
        if self.tenants:
            from repro_torch.scenarios.tenants import coerce_tenants
            object.__setattr__(self, "tenants",
                               coerce_tenants(self.tenants))
        else:
            object.__setattr__(self, "tenants", ())
        for field in ("replicas", "policies", "routers", "max_batches",
                      "speed_modes"):
            val = getattr(self, field)
            if isinstance(val, list):
                object.__setattr__(self, field, tuple(val))
        if isinstance(self.prefill_decode_splits, list):
            object.__setattr__(
                self, "prefill_decode_splits",
                tuple(tuple(s) for s in self.prefill_decode_splits))
        if self.fleets:
            # keep pools as plain dicts (JSON round-trip); the planner
            # coerces them into PoolSpec when it builds the grid
            object.__setattr__(
                self, "fleets",
                tuple(tuple(dict(p) if isinstance(p, dict) else p
                            for p in f) for f in self.fleets))
        else:
            object.__setattr__(self, "fleets", ())

    def to_dict(self) -> Dict[str, Any]:
        return dict(dataclasses.asdict(self), kind=self.kind)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PlanSpec":
        d = dict(d)
        d.pop("kind", None)
        return cls(**d)


AnyJobSpec = Union[BenchmarkJobSpec, CalibrationSpec, PlanSpec]

_SPEC_KINDS = {"benchmark": BenchmarkJobSpec, "calibration": CalibrationSpec,
               "plan": PlanSpec}


def spec_from_dict(d: Dict[str, Any]) -> AnyJobSpec:
    """Dict → typed spec, dispatching on the optional ``kind`` field
    (``benchmark`` when absent)."""
    kind = d.get("kind", "benchmark")
    cls = _SPEC_KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown job kind {kind!r} "
                         f"(expected one of {sorted(_SPEC_KINDS)})")
    d = {k: v for k, v in d.items() if k != "kind"}
    return cls(**d) if cls is not BenchmarkJobSpec \
        else BenchmarkJobSpec.from_dict(d)


def load_jobs(path: Union[str, Path]) -> List[AnyJobSpec]:
    """Expand a config file into concrete job specs.

    Accepted layouts (JSON or TOML):
      * a single job object (optionally ``kind: calibration | plan``),
      * ``{"base": {...}, "axes": {...}}`` — a sweep, expanded here,
      * ``{"jobs": [{...}, ...]}`` — an explicit job list.
    """
    data = _load_config_data(path)
    if "base" in data:
        return list(SweepSpec.from_dict(data).expand())
    if "jobs" in data:
        return [spec_from_dict(j) for j in data["jobs"]]
    return [spec_from_dict(data)]
