"""Runtime configuration knobs.

Equivalent of the reference's ``RAY_CONFIG`` table
(``src/ray/common/ray_config_def.h``, 218 knobs): every knob has a typed
default and is overridable via an environment variable
``RAY_TPU_TORCH_<NAME>`` or via the ``_system_config`` dict passed to
``ray_tpu_torch.init``.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field, fields
from typing import Any, Dict

_ENV_PREFIX = "RAY_TPU_TORCH_"


def _env_override(name: str, default: Any) -> Any:
    raw = os.environ.get(_ENV_PREFIX + name.upper())
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


@dataclass
class Config:
    # --- object store (reference: plasma defaults, ray_config_def.h) ---
    #: Objects at or below this size are passed inline in RPCs / stored in
    #: the in-process memory store (reference: max_direct_call_object_size).
    max_inline_object_size: int = 100 * 1024
    #: Fraction of system memory for the per-node shared-memory store.
    object_store_memory_fraction: float = 0.3
    #: Absolute cap (bytes) for the object store; 0 = derive from fraction.
    object_store_memory: int = 0
    #: Directory for spilled objects (reference: object_spilling_config).
    spill_dir: str = os.path.join(tempfile.gettempdir(), "ray_tpu_torch",
                                  "spill")
    #: Start spilling when the store passes this fraction of capacity.
    object_spilling_threshold: float = 0.8
    #: Bytes of the store segment to prefault at startup (background).
    #: Faulted pages make first-touch puts memcpy-class. Deliberately small:
    #: populated tmpfs pages are committed RAM, and several node managers
    #: can share one host (cluster_utils tests) — large objects are instead
    #: prefaulted per-create, and recycled extents stay warm.
    object_store_prefault_bytes: int = 256 << 20
    #: Owner-local small objects (reference: the in-process memory store +
    #: owner-based object directory, core_worker's ownership model). When
    #: on, inline-sized objects (puts and task returns at or below
    #: max_inline_object_size) are tracked ONLY by their owner: no
    #: controller directory entry, no REF_DELTAS traffic, freed by owner
    #: GC. A ref that escapes (serialized, passed as a task arg) promotes
    #: the object to controller tracking and publishes its value so
    #: borrowers and dep-parked tasks resolve exactly as before.
    #: RAY_TPU_TORCH_OWNER_LOCAL_OBJECTS=0 restores controller-tracked objects.
    owner_local_objects: bool = True

    # --- scheduler (reference: hybrid_scheduling_policy.h) ---
    #: Pack onto a node until its critical-resource utilization crosses this
    #: threshold, then spread (reference: scheduler_spread_threshold = 0.5).
    scheduler_spread_threshold: float = 0.5
    #: Top-k fraction of nodes considered for random choice among best
    #: (reference: scheduler_top_k_fraction).
    scheduler_top_k_fraction: float = 0.2
    scheduler_top_k_absolute: int = 1

    # --- health / heartbeats (reference: gcs_health_check_manager.h) ---
    health_check_period_ms: int = 1000
    #: grace before a delta-driven refcount zero actually frees the
    #: object: absorbs in-flight +1 deltas from other processes
    #: (cross-process batches have no global ordering)
    free_grace_s: float = 2.0
    #: how long a create blocks behind spilling/eviction before
    #: surfacing ObjectStoreFullError (plasma create-queue analog)
    store_full_timeout_s: float = 30.0
    health_check_timeout_ms: int = 10000
    #: Missed-heartbeat budget before a node is declared dead.
    health_check_failure_threshold: int = 5

    # --- tasks / retries ---
    #: Default max retries for normal tasks (reference: task max_retries=3).
    task_max_retries: int = 3
    #: Default max restarts for actors (0 = no restart).
    actor_max_restarts: int = 0
    #: Lease/worker reuse idle timeout (reference: idle_worker_killing).
    idle_worker_kill_s: float = 60.0
    #: Tasks kept in flight per leased worker (reference: pipelined lease
    #: reuse, direct_task_transport.h:157 OnWorkerIdle) — the worker
    #: executes serially from its local queue, so the lease holds ONE
    #: resource allocation regardless of depth.
    dispatch_pipeline_depth: int = 8
    #: workers to warm per node when a driver connects (reference:
    #: prestart_worker_first_driver); 0 disables
    prestart_workers: int = 2
    #: fork workers from a pre-imported zygote process (~ms per spawn)
    #: instead of cold interpreter boots (~seconds). The lever behind
    #: actor-burst throughput: every actor needs a fresh dedicated
    #: worker. RAY_TPU_TORCH_WORKER_ZYGOTE=0 restores cold spawns.
    worker_zygote: bool = True
    #: Max workers a node will start per CPU if unspecified.
    workers_per_cpu: int = 1

    # --- transport ---
    #: Base directory for this session (sockets, logs, spill).
    session_dir: str = ""
    #: msgpack/pickle wire chunk size for large transfers.
    transfer_chunk_bytes: int = 8 * 1024 * 1024
    #: Pull-manager admission budget: total bytes of concurrently
    #: in-flight inbound object pulls (reference: pull_manager.h retry
    #: budget). At least one pull is always admitted.
    max_inflight_pull_bytes: int = 256 << 20
    #: Fail a pull (and report the stale location) after this long.
    pull_timeout_s: float = 60.0
    #: Source-side flow control: max unacked chunks per outbound stream.
    stream_window_chunks: int = 4

    # --- OOM defense (reference: memory_monitor.h:52 +
    # worker_killing_policy.h:34) ---
    #: Kill workers when node memory passes this fraction; <=0 disables.
    memory_usage_threshold: float = 0.95
    memory_monitor_refresh_ms: int = 500
    #: Consecutive breaches required before killing (debounces spikes).
    memory_monitor_breaches: int = 2
    #: OOM kills retry from their own budget (reference: task_oom_retries
    #: is separate from max_retries), with a delay so a saturated node
    #: gets time to clear before the task lands again.
    task_oom_retries: int = 15
    oom_retry_delay_s: float = 1.0

    # --- reliable delivery (core/reliable.py: ack/retransmit for the
    # critical one-way control messages; reference role: gRPC retries +
    # raylet lease/reconnect give the reference at-least-once RPCs) ---
    #: RAY_TPU_TORCH_RELIABLE_DELIVERY=0 disables the sublayer (messages fall
    #: back to fire-and-forget; chaos drops of the critical set become
    #: designed-in hangs again).
    reliable_delivery: bool = True
    #: Retransmit backoff: equal-jitter exponential, base * 2^attempt
    #: capped. The base floor (base/2) must exceed the batched-ack RTT.
    retransmit_base_s: float = 0.25
    retransmit_cap_s: float = 5.0
    #: Give up (typed DeliveryFailedError via the on_fail hook) after
    #: this many transmissions without an ack or peer-death notice.
    #: Sized so a healed multi-second partition always recovers first.
    retransmit_max_attempts: int = 12
    #: Batched acks flush within this window (effectively piggybacking
    #: on traffic bursts without a per-message ack send).
    ack_flush_delay_s: float = 0.02
    #: Actor-side in-order admission: how long a call may wait for a
    #: missing predecessor (a dropped ACTOR_CALL being retransmitted)
    #: before the gap is skipped (reference:
    #: actor_scheduling_queue reorder wait). Sized to cover several
    #: retransmit backoff rounds; bounds delay, never hangs.
    actor_reorder_wait_s: float = 10.0

    # --- streaming generators (core ObjectRefGenerator; reference:
    # num_returns="streaming" + _generator_backpressure_num_objects) ---
    #: Consumer-paced credit window: a generator task pauses after this
    #: many yielded-but-unconsumed items until STREAM_CREDIT reports
    #: consumption (bounds the object store footprint of a fast
    #: producer). <= 0 disables backpressure. Per-call override via
    #: ``options(generator_backpressure_num_objects=...)``.
    generator_backpressure_num_objects: int = 64

    # --- MPMD pipeline (parallel/mpmd_pipeline.py) ---
    #: Seconds a pipeline stage's mailbox take may starve before the
    #: stage fails with a typed TimeoutError (a dead neighbor stage
    #: must surface as an error at the driver, never a hang). Sized
    #: well above any sane per-microbatch compute; shrink it in tests
    #: that provoke stalls. Per-pipeline override via
    #: ``MPMDPipeline(mailbox_deadline_s=...)``.
    pipeline_mailbox_deadline_s: float = 120.0

    # --- retries / fault tolerance hardening ---
    #: Lease/reconnect retry backoff: exponential with full jitter,
    #: base * 2^attempt capped at the cap (reference retry shape; the
    #: chaos harness forces many drivers to retry at once — full jitter
    #: de-correlates the herd). Replaces the historical fixed 2.0s sleep.
    lease_backoff_base_s: float = 0.5
    lease_backoff_cap_s: float = 10.0

    # --- dashboard / job REST (reference: dashboard/head.py) ---
    dashboard_enabled: bool = True
    #: 0 picks an ephemeral port; the chosen address is written to
    #: <session_dir>/dashboard.json.
    dashboard_port: int = 0
    #: Timeout for control-plane RPCs (s).
    rpc_timeout_s: float = 60.0

    # --- task events / observability ---
    task_events_report_interval_ms: int = 1000
    task_events_max_buffer: int = 100_000
    enable_timeline: bool = True
    #: Flight recorder (core/events.py): per-process bounded event ring
    #: flushed to the controller as TASK_EVENTS. Disable with
    #: RAY_TPU_TORCH_ENABLE_TASK_EVENTS=0 (traces/timeline go dark; the task
    #: path loses its only per-hop observability).
    enable_task_events: bool = True
    #: Ring capacity per process; overflow drops the OLDEST events,
    #: counted in the runtime_events_dropped_total metric.
    task_events_ring_size: int = 4096

    # --- per-request tracing (serve/request_trace.py, serve/slo.py) ---
    #: Per-request span recording on the serve path. Disabling turns
    #: the request plane dark (waterfalls, /api/v0/requests,
    #: `ray-tpu trace` all empty); aggregate serve metrics keep working.
    enable_request_trace: bool = True
    #: Tail sampling: 1-in-N requests ship their spans to the
    #: controller even when fast and healthy (seeded per-router, so a
    #: fixed seed gives a deterministic sample). Slow (SLO-tripped),
    #: failed, and shed requests ALWAYS ship. 0 disables the baseline
    #: sample (only slow/failed/shed ship).
    trace_sample_n: int = 100
    #: Completed request traces retained at the controller (drop-oldest).
    request_trace_max: int = 512
    #: SLO budgets evaluated per phase by the serve/slo.py watchdog.
    #: Tripping any budget flips the request to always-ship and
    #: increments serve_slo_violations_total{phase}. <=0 disables that
    #: budget.
    slo_queue_s: float = 1.0
    slo_ttft_s: float = 5.0
    slo_inter_token_p99_s: float = 1.0

    # --- fleet metrics plane (core/metrics_plane.py) ---
    #: Per-process periodic METRIC_REPORT snapshots to the controller.
    #: RAY_TPU_TORCH_ENABLE_METRICS_REPORT=0 turns the fleet plane dark
    #: (process-local /metrics endpoints keep working).
    enable_metrics_report: bool = True
    #: Reporter cadence per process (the fleet resolution floor).
    metrics_report_interval_ms: int = 1000
    #: Width of one time-series ring slot at the controller (rates and
    #: quantile windows are computed on this grid).
    metrics_ring_interval_s: float = 1.0
    #: Slots retained per (metric, labelset, origin) series — bounds
    #: the controller's memory (600 x 1s = 10 min of history).
    metrics_ring_slots: int = 600

    # --- GPU ---
    #: Name of the countable CUDA-device resource (reference:
    #: python/ray/_private/accelerators/nvidia_gpu.py uses "GPU").
    gpu_resource_name: str = "GPU"

    extra: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        for f in fields(self):
            if f.name == "extra":
                continue
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))

    def apply_system_config(self, system_config: Dict[str, Any]) -> None:
        for key, value in (system_config or {}).items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                self.extra[key] = value

    def to_json(self) -> str:
        d = {f.name: getattr(self, f.name) for f in fields(self) if f.name != "extra"}
        d.update(self.extra)
        return json.dumps(d)

    @classmethod
    def from_json(cls, raw: str) -> "Config":
        data = json.loads(raw)
        cfg = cls()
        cfg.apply_system_config(data)
        return cfg


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config()
    return _global_config


def set_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg
