"""Dashboard-lite: job submission + cluster-state REST API.

Reference: ``python/ray/dashboard/`` — the full aiohttp dashboard head
with per-module handlers. Here the surface is a stdlib ThreadingHTTPServer
in the head process serving JSON (a TPU pod head has no need for the
reference's React frontend or per-node agents; the state API already
aggregates cluster state at the controller).
"""

from ray_tpu_torch.dashboard.job_manager import JobManager, JobStatus

__all__ = ["JobManager", "JobStatus"]
