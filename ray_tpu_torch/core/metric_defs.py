"""Internal runtime metric definitions.

Reference: ``src/ray/stats/metric_defs.cc`` — the fixed set of runtime
metrics every Ray process exports (task counts by state, scheduler
queue depths, object-store usage, gRPC/ZMQ traffic, worker counts).
Here the same catalog is defined over :mod:`ray_tpu_torch.util.metrics`;
runtime components call the ``record_*`` helpers on their hot paths
(cheap: process-local counters, exported with user metrics through the
same Prometheus endpoint).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

_lock = threading.Lock()
_defs: Optional["RuntimeMetrics"] = None


class RuntimeMetrics:
    """The runtime metric catalog (created once per process)."""

    def __init__(self):
        # -- tasks (reference: ray_tasks metric, by State/Name)
        self.tasks_submitted = Counter(
            "runtime_tasks_submitted_total",
            "Tasks submitted by this process")
        self.tasks_finished = Counter(
            "runtime_tasks_finished_total",
            "Task completions observed", tag_keys=("outcome",))
        self.task_exec_seconds = Histogram(
            "runtime_task_execution_seconds",
            "Wall time of task execution on this worker")
        # -- scheduler (reference: scheduler_tasks / scheduler_unscheduleable)
        self.sched_queued = Gauge(
            "runtime_scheduler_queued_tasks",
            "Tasks in the controller's ready queues")
        self.sched_pending_args = Gauge(
            "runtime_scheduler_pending_args_tasks",
            "Tasks parked waiting for dependencies")
        self.sched_infeasible = Gauge(
            "runtime_scheduler_infeasible_tasks",
            "Tasks whose resource shape currently fits no node")
        # -- objects (reference: object_store_memory / object_directory)
        self.object_store_bytes = Gauge(
            "runtime_object_store_used_bytes",
            "Bytes used in the local shared-memory store")
        self.object_store_objects = Gauge(
            "runtime_object_store_num_objects",
            "Sealed objects resident in the local store")
        self.objects_tracked = Gauge(
            "runtime_object_directory_size",
            "Objects the controller tracks cluster-wide")
        self.puts = Counter(
            "runtime_puts_total", "ray_tpu_torch.put calls")
        self.put_bytes = Counter(
            "runtime_put_bytes_total", "Bytes written by put")
        self.materialized_bytes = Counter(
            "runtime_object_bytes_materialized_total",
            "Bytes of object payloads this process materialized from "
            "the shm store / remote holders (inbound transfer "
            "accounting: what ray_tpu_torch.get actually moved here)")
        # -- workers / actors (reference: actors-by-state, worker counts)
        self.workers_alive = Gauge(
            "runtime_workers_alive", "Worker processes registered")
        self.actors_alive = Gauge(
            "runtime_actors_alive", "Actors in ALIVE state")
        self.actors_pending = Gauge(
            "runtime_actors_pending", "Actors awaiting placement/start")
        # -- transport (reference: grpc_server_req counters)
        self.messages_sent = Counter(
            "runtime_messages_sent_total",
            "Control-plane messages sent", tag_keys=("kind",))
        self.message_batch_size = Histogram(
            "runtime_message_batch_size",
            "Messages coalesced per wire batch")
        # -- reliable delivery (core/reliable.py hot paths)
        self.retransmits = Counter(
            "runtime_reliable_retransmits_total",
            "Reliable-layer retransmissions", tag_keys=("type",))
        self.ack_batch_size = Histogram(
            "runtime_reliable_ack_batch_size",
            "Wire seqs acknowledged per MSG_ACK message",
            boundaries=[1, 2, 5, 10, 20, 50, 100, 250])
        self.ack_rtt = Histogram(
            "runtime_reliable_ack_rtt_seconds",
            "Send-to-ack latency of reliably-delivered messages "
            "(retransmit attempts included)")
        self.dup_dropped = Counter(
            "runtime_reliable_dup_dropped_total",
            "Retransmit duplicates discarded by the receive dedup")
        self.delivery_failed = Counter(
            "runtime_reliable_delivery_failed_total",
            "Messages abandoned at the attempt cap "
            "(DeliveryFailedError)")
        # -- streaming generators
        self.credit_stall_seconds = Counter(
            "runtime_stream_credit_stall_seconds_total",
            "Seconds streaming producers spent blocked on the "
            "backpressure window waiting for STREAM_CREDIT")
        # -- serve LLM engine (serve/llm_engine.py): per-replica
        # scheduler signals — the queue-latency/occupancy family the
        # autoscaler consumes (ROADMAP item 1)
        self.serve_queue_depth = Gauge(
            "serve_engine_queue_depth",
            "Requests waiting for a decode slot on this replica")
        self.serve_batch_occupancy = Histogram(
            "serve_engine_batch_occupancy",
            "Active decode slots per batched decode step",
            boundaries=[1, 2, 4, 8, 16, 32, 64])
        self.serve_ttft = Histogram(
            "serve_engine_ttft_seconds",
            "Submit-to-first-token latency (chunked prefill included)",
            boundaries=[0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10])
        self.serve_tokens = Counter(
            "serve_engine_tokens_total",
            "Tokens generated by this replica's engine")
        self.serve_tokens_per_s = Gauge(
            "serve_engine_tokens_per_s",
            "Engine decode throughput since start")
        self.serve_prefix_hits = Counter(
            "serve_engine_prefix_hit_blocks_total",
            "Prompt KV blocks whose prefill was skipped via a radix "
            "prefix-cache match (shared or copy-on-write)")
        self.serve_blocks_shared = Gauge(
            "serve_engine_blocks_shared",
            "KV blocks currently referenced by more than one sequence")
        self.serve_spec_accept = Histogram(
            "serve_engine_spec_accept_ratio",
            "Accepted/drafted ratio per speculative verify step "
            "(prompt-lookup multi-token decode)",
            boundaries=[0.0, 0.25, 0.5, 0.75, 1.0])
        # -- disaggregated prefill/decode hand-off (serve/disagg.py)
        self.serve_kv_ship_bytes = Counter(
            "serve_kv_ship_bytes_total",
            "Wire bytes of finished prefill KV blocks shipped toward "
            "decode replicas (bf16 raw or int8 blockwise payloads)",
            tag_keys=("wire",))
        self.serve_kv_ship_seconds = Histogram(
            "serve_kv_ship_seconds",
            "Ship-to-adopt wall per disagg hand-off (prefill export "
            "complete to decode-side blocks adopted)",
            boundaries=[0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                        0.5, 1, 2.5])
        self.serve_prefix_migrated = Counter(
            "serve_prefix_migrated_blocks_total",
            "Warm radix-trie KV blocks exported off draining replicas "
            "and adopted by survivors (warm-prefix migration)",
            tag_keys=("dir",))
        # -- flight recorder (core/events.py)
        self.events_dropped = Counter(
            "runtime_events_dropped_total",
            "Flight-recorder events dropped at the ring-buffer cap")
        # -- fleet metrics plane (core/metrics_plane.py)
        self.metric_reports_dropped = Counter(
            "runtime_metric_reports_dropped_total",
            "METRIC_REPORT snapshots abandoned by this process "
            "(superseded in-flight reports beyond the pending bound, "
            "or a down send path)", tag_keys=("reason",))
        self.metrics_update_errors = Counter(
            "runtime_metrics_update_errors_total",
            "update_from_state gauge-refresh failures (a broken gauge "
            "path is visible here instead of silently swallowed)",
            tag_keys=("source",))
        # -- training telemetry (models/training.py + MPMDPipeline):
        # the live versions of what bench.py records offline
        self.train_step_wall = Histogram(
            "train_step_wall_seconds",
            "Wall time per optimizer step (dispatch to completion)",
            boundaries=[0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5,
                        10, 30])
        self.train_tokens_per_s = Gauge(
            "train_tokens_per_s",
            "Training throughput over the last telemetry window")
        self.train_loss = Gauge(
            "train_loss", "Most recent training loss")
        self.train_grad_norm = Gauge(
            "train_grad_norm", "Most recent global gradient norm")
        self.train_mfu = Gauge(
            "train_mfu_pct",
            "Model FLOP utilization (%) from the bench FLOP model "
            "(flops_per_token x tokens/s over the chip's bf16 peak)")
        # -- MPMD pipeline (parallel/mpmd_pipeline.py)
        self.pipeline_mailbox_depth = Gauge(
            "pipeline_stage_mailbox_depth",
            "Microbatches parked in a stage actor's mailboxes "
            "(activations + grads + targets)", tag_keys=("stage",))
        self.pipeline_bubble = Gauge(
            "pipeline_bubble_fraction",
            "Measured pipeline bubble of the most recent step")
        # -- slice autoscaling (autoscaler/slices.py): the gang unit's
        # lifecycle as fleet gauges
        self.slices_up = Gauge(
            "autoscaler_slices_up",
            "TPU slices fully joined (every host VM registered and "
            "alive)")
        self.slice_hosts_pending = Gauge(
            "autoscaler_slice_hosts_pending",
            "Host VMs of acquired slices that have not registered yet")
        self.slice_drain_seconds = Histogram(
            "autoscaler_slice_drain_seconds",
            "Notice-to-release drain duration per slice (maintenance "
            "or idle scale-down)",
            boundaries=[0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120])
        # -- slice arbitration (autoscaler/arbiter.py) + SLO admission
        # (serve/handle.py): train+serve colocation signals
        self.arbiter_preemptions = Counter(
            "autoscaler_arbiter_preemptions_total",
            "Training slices drained by the slice arbiter for the "
            "serve fleet", tag_keys=("reason",))
        self.arbiter_returns = Counter(
            "autoscaler_arbiter_returns_total",
            "Borrowed slices handed back to training after serve "
            "pressure ebbed past hysteresis", tag_keys=("reason",))
        self.admission_rejected = Counter(
            "serve_admission_rejected_total",
            "Requests shed by SLO-aware admission before reaching a "
            "replica queue", tag_keys=("tenant", "priority"))
        # -- per-request tracing (serve/request_trace.py, serve/slo.py)
        self.serve_slo_violations = Counter(
            "serve_slo_violations_total",
            "Per-phase SLO budget trips flagged by the serve SLO "
            "watchdog; each trip flips its request's trace to "
            "always-ship", tag_keys=("phase",))
        self.request_spans_shipped = Counter(
            "serve_request_spans_shipped_total",
            "Request-trace span batches shipped to the controller "
            "under tail sampling (slow, failed/shed, or 1-in-N)")
        # -- memory / health (reference: memory_manager worker kills)
        self.oom_worker_kills = Counter(
            "runtime_oom_worker_kills_total",
            "Workers killed by the memory monitor")
        self.node_mem_percent = Gauge(
            "runtime_node_memory_used_percent",
            "Node memory utilization")


def runtime_metrics() -> RuntimeMetrics:
    global _defs
    with _lock:
        if _defs is None:
            _defs = RuntimeMetrics()
        return _defs


#: sources whose update_from_state failure has already been logged —
#: the counter keeps counting, the log fires once per (process, source)
_update_error_logged: set = set()


def _count_update_error(m: "RuntimeMetrics", source: str) -> None:
    try:
        m.metrics_update_errors.inc(tags={"source": source})
    except Exception:
        pass
    if source not in _update_error_logged:
        _update_error_logged.add(source)
        import logging
        logging.getLogger(__name__).warning(
            "update_from_state: %s gauge refresh failed (logged once; "
            "further failures count in "
            "runtime_metrics_update_errors_total)", source,
            exc_info=True)


def update_from_state(controller=None, store_stats: Optional[Dict] = None,
                      node_stats: Optional[Dict] = None) -> None:
    """Refresh gauge families from component state (called from the
    heartbeat/stats paths — gauges snapshot, counters accumulate).
    A failing gauge path is counted in
    ``runtime_metrics_update_errors_total`` and logged once instead of
    silently swallowed."""
    m = runtime_metrics()
    if controller is not None:
        try:
            m.sched_queued.set(
                sum(len(q) for q in controller.ready_queues.values()))
            m.sched_pending_args.set(sum(
                1 for t in controller.tasks.values()
                if t.state == "PENDING_DEPS"))
            m.objects_tracked.set(len(controller.objects))
            m.workers_alive.set(sum(
                len(n.all_workers) for n in controller.nodes.values()))
            m.actors_alive.set(sum(
                1 for a in controller.actors.values()
                if a.state == "ALIVE"))
            m.actors_pending.set(sum(
                1 for a in controller.actors.values()
                if a.state in ("PENDING", "STARTING", "RESTARTING")))
        except Exception:
            _count_update_error(m, "controller")
    if store_stats:
        try:
            m.object_store_bytes.set(store_stats.get("used_bytes", 0))
            m.object_store_objects.set(
                store_stats.get("num_objects", 0))
        except Exception:
            _count_update_error(m, "store")
    if node_stats:
        try:
            pct = node_stats.get("mem_percent")
            if pct is not None:
                m.node_mem_percent.set(pct)
        except Exception:
            _count_update_error(m, "node")
