"""The serving metric catalog: the port's copy of the ``serve_*``
metrics and ``request_spans_shipped`` of
``ray_tpu/core/metric_defs.py::RuntimeMetrics``, under the same metric
names, over :mod:`ray_tpu_torch.util.metrics`. The task, scheduler,
object-store, transport and training families belong to the runtime and
the trainer's telemetry, which the port does not have yet.
"""

from __future__ import annotations

import threading
from typing import Optional

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

_lock = threading.Lock()
_defs: Optional["RuntimeMetrics"] = None


class RuntimeMetrics:
    """The serving metrics (created once per process)."""

    def __init__(self):
        # -- serve LLM engine (serve/llm_engine.py): per-replica
        # scheduler signals
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
        # -- per-request tracing (serve/request_trace.py, serve/slo.py)
        self.serve_slo_violations = Counter(
            "serve_slo_violations_total",
            "Per-phase SLO budget trips flagged by the serve SLO "
            "watchdog; each trip flips its request's trace to "
            "always-ship", tag_keys=("phase",))
        self.request_spans_shipped = Counter(
            "serve_request_spans_shipped_total",
            "Request-trace span batches shipped under tail sampling "
            "(slow, failed/shed, or 1-in-N)")


def runtime_metrics() -> RuntimeMetrics:
    global _defs
    with _lock:
        if _defs is None:
            _defs = RuntimeMetrics()
        return _defs
