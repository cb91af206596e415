"""Per-process trial context: the placement group a trial actor was
scheduled into, so nested worker groups (a Trainer running inside a Tune
trial) reuse the trial's reserved bundles instead of reserving twice.

Reference analog: placement groups with ``capture_child_tasks`` plumbed
through ``tune/execution``; here it's an explicit handoff.
"""

from __future__ import annotations

from typing import Optional

_trial_pg = None
_trial_dir: Optional[str] = None


def set_trial_placement_group(pg) -> None:
    global _trial_pg
    _trial_pg = pg


def get_trial_placement_group():
    return _trial_pg


def set_trial_dir(path: Optional[str]) -> None:
    global _trial_dir
    _trial_dir = path


def get_trial_dir() -> Optional[str]:
    return _trial_dir
