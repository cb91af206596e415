"""ray_tpu_torch.workflow: durable DAG execution
(reference: ``python/ray/workflow/``).

``workflow.run(dag, workflow_id=...)`` executes a task DAG with every
task output checkpointed to storage (``task_executor.py:50``,
``WorkflowStorage`` :229); re-running or ``resume()`` after a crash
skips completed tasks and replays only the rest. The port's copy of
``ray_tpu/workflow``.
"""

from ray_tpu_torch.workflow.events import (
    EventListener,
    HTTPListener,
    TimerListener,
    deliver_event,
    start_http_event_provider,
    wait_for_event,
)
from ray_tpu_torch.workflow.api import (
    delete,
    get_metadata,
    get_output,
    get_status,
    init_storage,
    list_all,
    resume,
    run,
    run_async,
)

__all__ = [
    "EventListener",
    "HTTPListener",
    "TimerListener",
    "delete",
    "deliver_event",
    "start_http_event_provider",
    "wait_for_event",
    "get_metadata",
    "get_output",
    "get_status",
    "init_storage",
    "list_all",
    "resume",
    "run",
    "run_async",
]
