"""Job submission SDK (reference: ``python/ray/dashboard/modules/job/sdk.py``
``JobSubmissionClient`` — same method surface over the same REST routes,
using stdlib urllib instead of requests)."""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from ray_tpu_torch.dashboard.job_manager import JobStatus

__all__ = ["JobSubmissionClient", "JobStatus"]


def _find_dashboard_address(address: Optional[str]) -> str:
    if address:
        return address.rstrip("/")
    env = os.environ.get("RAY_TPU_TORCH_DASHBOARD_ADDRESS")
    if env:
        return env.rstrip("/")
    # resolve from a session dir (RAY_TPU_TORCH_ADDRESS or the newest session)
    session = os.environ.get("RAY_TPU_TORCH_SESSION_DIR") \
        or os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if session:
        path = os.path.join(session, "dashboard.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)["address"].rstrip("/")
    raise RuntimeError(
        "cannot locate the dashboard: pass address= (http://host:port) or "
        "set RAY_TPU_TORCH_DASHBOARD_ADDRESS / RAY_TPU_TORCH_ADDRESS")


class JobSubmissionClient:
    def __init__(self, address: Optional[str] = None):
        self.address = _find_dashboard_address(address)

    # ------------------------------------------------------------- http
    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> Any:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.address + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("error", "")
            except Exception:
                detail = ""
            raise RuntimeError(
                f"{method} {path} failed ({e.code}): {detail}") from None

    # -------------------------------------------------------------- api
    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   priority: str = "normal",
                   elastic: bool = False) -> str:
        """``priority`` (low/normal/high) orders this job in slice
        arbitration — under sustained serve pressure the SliceArbiter
        preempts the LOWEST-priority training job's slice first;
        ``elastic=True`` declares the driver survives that (it wraps
        training in ElasticTrainer and resumes on the shrunken mesh)."""
        out = self._request("POST", "/api/jobs/", {
            "entrypoint": entrypoint, "submission_id": submission_id,
            "metadata": metadata, "runtime_env": runtime_env,
            "priority": priority, "elastic": elastic})
        return out["submission_id"]

    def get_arbiter_status(self) -> Dict[str, Any]:
        """Live slice-arbitration table: who owns which slice and why
        (borrowed-by-serve rows carry the preemption reason)."""
        return self._request("GET", "/api/v0/arbiter")

    def list_jobs(self) -> List[Dict[str, Any]]:
        return self._request("GET", "/api/jobs/")

    def get_job_info(self, submission_id: str) -> Dict[str, Any]:
        return self._request("GET", f"/api/jobs/{submission_id}")

    def get_job_status(self, submission_id: str) -> str:
        return self.get_job_info(submission_id)["status"]

    def get_job_logs(self, submission_id: str) -> str:
        return self._request(
            "GET", f"/api/jobs/{submission_id}/logs")["logs"]

    def stop_job(self, submission_id: str) -> bool:
        return self._request(
            "POST", f"/api/jobs/{submission_id}/stop")["stopped"]

    def wait_until_status(self, submission_id: str,
                          statuses=JobStatus.TERMINAL,
                          timeout_s: float = 300.0) -> str:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in statuses:
                return status
            time.sleep(0.5)
        raise TimeoutError(
            f"job {submission_id} not in {statuses} after {timeout_s}s")
