"""Job manager: run driver scripts against the cluster, track their fate.

Reference: ``python/ray/dashboard/modules/job/job_manager.py:525`` —
JobManager spawns a JobSupervisor actor per job which execs the entrypoint
and monitors it. Here the supervisor is a thread in the head process
supervising the entrypoint subprocess directly: the entrypoint is its own
driver process either way, and a TPU head has no multi-tenant isolation
need that would justify an actor hop. Environment propagation
(RAY_TPU_TORCH_ADDRESS) makes the child's ``ray_tpu_torch.init()`` connect to this
cluster, like the reference's RAY_ADDRESS injection.
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time
import uuid
from typing import Any, Dict, List, Optional


class JobStatus:
    """Reference: ``python/ray/dashboard/modules/job/common.py`` JobStatus."""
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"

    TERMINAL = frozenset({STOPPED, SUCCEEDED, FAILED})


class JobInfo:
    def __init__(self, submission_id: str, entrypoint: str,
                 metadata: Optional[Dict[str, str]] = None,
                 runtime_env: Optional[Dict[str, Any]] = None,
                 priority: str = "normal", elastic: bool = False):
        self.submission_id = submission_id
        self.entrypoint = entrypoint
        self.metadata = metadata or {}
        self.runtime_env = runtime_env or {}
        # arbitration hints: priority orders preemption victims (the
        # SliceArbiter drains the lowest-priority training job's slice
        # first); elastic declares the driver survives losing a slice
        # mid-run (ElasticTrainer re-lowers instead of dying)
        self.priority = priority
        self.elastic = bool(elastic)
        self.status = JobStatus.PENDING
        self.message = ""
        self.start_time = time.time()
        self.end_time: Optional[float] = None
        self.driver_exit_code: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "submission_id": self.submission_id,
            "entrypoint": self.entrypoint,
            "status": self.status,
            "message": self.message,
            "metadata": self.metadata,
            "runtime_env": {k: v for k, v in self.runtime_env.items()
                            if k != "env_vars"} if self.runtime_env else {},
            "priority": self.priority,
            "elastic": self.elastic,
            "start_time": self.start_time,
            "end_time": self.end_time,
            "driver_exit_code": self.driver_exit_code,
        }


class JobManager:
    def __init__(self, session_dir: str):
        self.session_dir = session_dir
        self.log_dir = os.path.join(session_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self._jobs: Dict[str, JobInfo] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- submit
    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   priority: str = "normal",
                   elastic: bool = False) -> str:
        submission_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:12]}"
        if priority not in ("low", "normal", "high"):
            raise ValueError(
                f"priority must be low/normal/high, got {priority!r}")
        with self._lock:
            if submission_id in self._jobs:
                raise ValueError(f"job {submission_id!r} already exists")
            info = JobInfo(submission_id, entrypoint, metadata,
                           runtime_env, priority=priority,
                           elastic=elastic)
            self._jobs[submission_id] = info
        t = threading.Thread(target=self._supervise, args=(info,),
                             name=f"job-supervisor-{submission_id}",
                             daemon=True)
        t.start()
        return submission_id

    def _supervise(self, info: JobInfo) -> None:
        """Per-job supervisor (reference: JobSupervisor.run): exec the
        entrypoint wired to this cluster, stream output to the job log,
        record the terminal status from the exit code."""
        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = self.session_dir
        env["RAY_TPU_TORCH_JOB_SUBMISSION_ID"] = info.submission_id
        # drivers read these to claim their slices with the arbiter at
        # the right priority (and to decide whether to wrap training in
        # ElasticTrainer)
        env["RAY_TPU_TORCH_JOB_PRIORITY"] = info.priority
        env["RAY_TPU_TORCH_JOB_ELASTIC"] = "1" if info.elastic else "0"
        # the entrypoint's driver must find ray_tpu_torch even when the package
        # is run from a source tree (same propagation the node manager
        # does for workers)
        import ray_tpu_torch
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.abspath(ray_tpu_torch.__file__)))
        existing = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in [pkg_parent, existing] if p)
        renv = info.runtime_env or {}
        for k, v in (renv.get("env_vars") or {}).items():
            env[k] = str(v)
        cwd = renv.get("working_dir") or None
        if cwd is not None and not os.path.isdir(cwd):
            with self._lock:
                info.status = JobStatus.FAILED
                info.message = f"working_dir {cwd!r} does not exist"
                info.end_time = time.time()
            return
        log = open(self.log_path(info.submission_id), "ab")
        try:
            proc = subprocess.Popen(
                info.entrypoint, shell=True, env=env, cwd=cwd,
                stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)
        except OSError as e:
            with self._lock:
                info.status = JobStatus.FAILED
                info.message = f"failed to start entrypoint: {e}"
                info.end_time = time.time()
            log.close()
            return
        with self._lock:
            # a stop() racing startup wins: kill immediately
            if info.status == JobStatus.STOPPED:
                _terminate(proc)
            else:
                info.status = JobStatus.RUNNING
                info.message = "job is running"
            self._procs[info.submission_id] = proc
        code = proc.wait()
        log.close()
        with self._lock:
            self._procs.pop(info.submission_id, None)
            info.end_time = time.time()
            info.driver_exit_code = code
            if info.status == JobStatus.STOPPED:
                info.message = "job was stopped"
            elif code == 0:
                info.status = JobStatus.SUCCEEDED
                info.message = "job finished successfully"
            else:
                info.status = JobStatus.FAILED
                info.message = f"driver exited with code {code}"

    # -------------------------------------------------------------- query
    def get_job_info(self, submission_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            info = self._jobs.get(submission_id)
            return info.to_dict() if info else None

    def list_jobs(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [i.to_dict() for i in self._jobs.values()]

    def log_path(self, submission_id: str) -> str:
        return os.path.join(self.log_dir, f"job-{submission_id}.log")

    def get_job_logs(self, submission_id: str) -> str:
        try:
            with open(self.log_path(submission_id), "rb") as f:
                return f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""

    def stop_job(self, submission_id: str) -> bool:
        with self._lock:
            info = self._jobs.get(submission_id)
            if info is None:
                raise KeyError(submission_id)
            if info.status in JobStatus.TERMINAL:
                return False
            info.status = JobStatus.STOPPED
            proc = self._procs.get(submission_id)
        if proc is not None:
            _terminate(proc)
        return True

    def shutdown(self) -> None:
        # SIGTERM everything first, then one shared grace deadline before
        # SIGKILL — shutdown cost stays ~grace_s no matter how many jobs
        with self._lock:
            procs = list(self._procs.values())
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError, OSError):
                pass
        deadline = time.monotonic() + 3.0
        for p in procs:
            while time.monotonic() < deadline and p.poll() is None:
                time.sleep(0.05)
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError, OSError):
                    pass


def _terminate(proc: subprocess.Popen, grace_s: float = 3.0) -> None:
    """SIGTERM the entrypoint's process group, escalate to SIGKILL
    (reference: JobSupervisor.stop's polite-then-forceful kill)."""
    try:
        os.killpg(proc.pid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError, OSError):
        return
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return
        time.sleep(0.05)
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        pass
