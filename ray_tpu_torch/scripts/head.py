"""Head-node daemon entry: ``python -m ray_tpu_torch.scripts.head``.

Runs controller + node manager and blocks until signaled. Started by
``cli start --head`` and the local launcher's ``up`` (reference analog:
``python/ray/_private/services.py`` daemon spawning).

With ``--cluster-config <yaml>`` the head also owns the slice layer:
when the config has a ``slices:`` section it constructs the
SliceManager (``autoscaler/launcher.py::build_slice_manager`` — slices
the launcher already created are adopted, not re-acquired) and polls it
under an ``AutoscalerMonitor``, so pending SLICE_PACK/SLICE_SPREAD
gangs acquire slices and maintenance drains run WITHOUT any driver or
test building the manager by hand (ROADMAP item 1).

The port's copy of ``ray_tpu/scripts/head.py``: ``--num-gpus`` counts the
head's CUDA devices, and the default address is published under the
port's session root (``api.session_root()``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
import uuid


def _start_slice_monitor(config_path: str, interval_s: float):
    """Build the SliceManager from the cluster config and start its
    monitor loop. When the config also has an ``arbiter:`` section the
    monitor drives the SliceArbiter instead — it reconciles the
    manager first each tick, then arbitrates slices between the serve
    fleet and training off the metrics plane's fleet gauges. Returns
    (monitor, manager) or (None, None) when the config has no slices
    section."""
    import ray_tpu_torch.api as api
    from ray_tpu_torch.autoscaler.autoscaler import AutoscalerMonitor
    from ray_tpu_torch.autoscaler.launcher import (
        build_slice_arbiter, build_slice_manager, load_cluster_config)

    cfg = load_cluster_config(config_path)
    mgr = build_slice_manager(api._head.controller, cfg)
    if mgr is None:
        return None, None
    arbiter = build_slice_arbiter(mgr, cfg)
    if arbiter is not None:
        api._head.controller.slice_arbiter = arbiter
    monitor = AutoscalerMonitor(arbiter if arbiter is not None
                                else mgr, interval_s=interval_s)
    monitor.start()
    print(f"ray_tpu_torch head: slice monitor up "
          f"({', '.join(sorted(mgr.slice_types))})"
          + (" + arbiter" if arbiter is not None else ""))
    sys.stdout.flush()
    return monitor, mgr


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--session-dir", default=None)
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None)
    p.add_argument("--resources", default="{}")
    p.add_argument("--initial-workers", type=int, default=2)
    p.add_argument("--cluster-config", default=None,
                   help="validated cluster YAML; a slices: section "
                        "auto-starts the SliceManager monitor")
    p.add_argument("--slice-monitor-interval-s", type=float,
                   default=1.0)
    args = p.parse_args()

    import ray_tpu_torch
    # A head daemon must not inherit a driver's RAY_TPU_TORCH_ADDRESS: it IS
    # the cluster. --session-dir pins the session path if given.
    os.environ.pop("RAY_TPU_TORCH_ADDRESS", None)
    info = ray_tpu_torch.init(
        num_cpus=args.num_cpus, num_gpus=args.num_gpus,
        resources=json.loads(args.resources),
        _num_initial_workers=args.initial_workers,
        _session_dir=args.session_dir)
    # Publish the default address for `cli` subcommands and drivers.
    from ray_tpu_torch.scripts.cli import LATEST
    os.makedirs(os.path.dirname(LATEST), exist_ok=True)
    with open(LATEST, "w") as f:
        f.write(info["session_dir"])
    print(f"ray_tpu_torch head running; session_dir={info['session_dir']}")
    sys.stdout.flush()

    monitor = mgr = None
    if args.cluster_config:
        try:
            monitor, mgr = _start_slice_monitor(
                args.cluster_config, args.slice_monitor_interval_s)
        except Exception as e:  # noqa: BLE001 — head must still serve
            print(f"ray_tpu_torch head: slice monitor failed to start: {e}")
            sys.stdout.flush()

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    if monitor is not None:
        monitor.stop()
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
