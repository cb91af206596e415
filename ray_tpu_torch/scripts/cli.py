"""The port's command line: ``python -m ray_tpu_torch.scripts.cli
<command>``, the port's copy of ``ray_tpu/scripts/cli.py``.

Reference: ``python/ray/scripts/scripts.py`` (``start`` :567, ``stop``
:1043, ``submit`` :1577, status/memory/timeline/microbenchmark and the
``ray list``/``ray summary`` state commands from ``state_cli.py``).
``LATEST`` and ``PIDFILE`` live under the port's session root
(``api.session_root()``), so a JAX head and a port head on one host do
not read each other's; ``start --num-gpus`` counts the node's CUDA
devices (the JAX CLI's ``--num-tpus``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

from ray_tpu_torch.api import session_root

ROOT = session_root()
LATEST = os.path.join(ROOT, "latest_session")
PIDFILE = os.path.join(ROOT, "head.pid")


def _default_address() -> str:
    addr = os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if addr:
        return addr
    if os.path.exists(LATEST):
        with open(LATEST) as f:
            return f.read().strip()
    raise SystemExit(
        "No running cluster found (start one with `cli start --head`"
        " or set RAY_TPU_TORCH_ADDRESS)")


def _connect():
    import ray_tpu_torch
    ray_tpu_torch.init(address=_default_address())
    return ray_tpu_torch


def cmd_start(args) -> None:
    os.makedirs(ROOT, exist_ok=True)
    if args.head:
        cmd = [sys.executable, "-m", "ray_tpu_torch.scripts.head",
               "--initial-workers", str(args.initial_workers)]
        if args.num_cpus is not None:
            cmd += ["--num-cpus", str(args.num_cpus)]
        if args.num_gpus is not None:
            cmd += ["--num-gpus", str(args.num_gpus)]
        if args.resources:
            cmd += ["--resources", args.resources]
        log = open(os.path.join(ROOT, "head.log"), "ab")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        with open(PIDFILE, "w") as f:
            f.write(str(proc.pid))
        for _ in range(100):
            if os.path.exists(LATEST):
                mtime = os.path.getmtime(LATEST)
                if mtime >= time.time() - 60:
                    break
            time.sleep(0.2)
        print(f"Started head (pid {proc.pid}); "
              f"address: {_default_address()}")
    else:
        address = args.address or _default_address()
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.node",
               "--session-dir", address,
               "--initial-workers", str(args.initial_workers)]
        if args.num_cpus is not None:
            cmd += ["--num-cpus", str(args.num_cpus)]
        if args.num_gpus is not None:
            cmd += ["--num-gpus", str(args.num_gpus)]
        if getattr(args, "labels", None):
            # "k=v,k2=v2" — the cluster launcher stamps
            # ray-tpu-node-id=<slice> (gce.LABEL_NODE_ID) here so the autoscaler can join
            # provider slices to registered nodes
            labels = {}
            for kv in args.labels.split(","):
                if "=" not in kv:
                    raise SystemExit(
                        f"--labels: {kv!r} is not k=v (values must "
                        f"not contain commas)")
                k, v = kv.split("=", 1)
                labels[k] = v
            cmd += ["--labels", json.dumps(labels)]
        log = open(os.path.join(ROOT, "node.log"), "ab")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        print(f"Started node (pid {proc.pid}) joined to {address}")


def cmd_stop(args) -> None:
    if os.path.exists(PIDFILE):
        with open(PIDFILE) as f:
            pid = int(f.read())
        try:
            os.kill(pid, signal.SIGTERM)
            print(f"Stopped head (pid {pid})")
        except ProcessLookupError:
            print("Head already stopped")
        os.remove(PIDFILE)
    for f in (LATEST,):
        if os.path.exists(f):
            os.remove(f)


def cmd_status(args) -> None:
    ray_tpu_torch = _connect()
    total = ray_tpu_torch.cluster_resources()
    avail = ray_tpu_torch.available_resources()
    nodes = ray_tpu_torch.nodes()
    print(f"Nodes: {sum(1 for n in nodes if n['alive'])} alive "
          f"/ {len(nodes)} total")
    print("Resources:")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0):g}/{total[k]:g} available")


def cmd_list(args) -> None:
    _connect()
    from ray_tpu_torch.util import state
    fn = getattr(state, f"list_{args.what}", None)
    if fn is None:
        raise SystemExit(f"Cannot list {args.what!r}")
    filters = []
    for f in args.filter or []:
        if "!=" in f:
            k, v = f.split("!=", 1)
            filters.append((k, "!=", v))
        else:
            k, v = f.split("=", 1)
            filters.append((k, "=", v))
    rows = fn(filters=filters, limit=args.limit)
    print(json.dumps(rows, indent=2, default=str))


def cmd_summary(args) -> None:
    _connect()
    from ray_tpu_torch.util import state
    fn = getattr(state, f"summarize_{args.what}")
    print(json.dumps(fn(), indent=2, default=str))


def cmd_memory(args) -> None:
    _connect()
    from ray_tpu_torch.util import state
    print(json.dumps(state.summarize_objects(), indent=2))


def cmd_top(args) -> None:
    """`cli top` — live fleet view from the cluster metrics plane
    (tools/top.py renders; the dashboard's /api/v0/metrics/fleet
    serves)."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, repo_root)
    try:
        from tools.top import main as top_main
    except ImportError:
        raise SystemExit(
            "cli top needs tools/top.py from the repository "
            "checkout (run `python tools/top.py` directly)")
    argv = []
    if args.dashboard:
        argv += ["--dashboard", args.dashboard]
    if args.once:
        argv += ["--once"]
    argv += ["--interval", str(args.interval),
             "--window", str(args.window)]
    raise SystemExit(top_main(argv))


def cmd_trace(args) -> None:
    """`cli trace <request_id>` — one serve request's waterfall
    from the controller's tail-sampled trace store (tools/trace.py
    renders; the dashboard's /api/v0/requests/<id> serves)."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, repo_root)
    try:
        from tools.trace import main as trace_main
    except ImportError:
        raise SystemExit(
            "cli trace needs tools/trace.py from the repository "
            "checkout (run `python tools/trace.py` directly)")
    argv = []
    if args.request_id:
        argv.append(args.request_id)
    if args.dashboard:
        argv += ["--dashboard", args.dashboard]
    if args.input:
        argv += ["--input", args.input]
    if args.perfetto:
        argv += ["--perfetto", args.perfetto]
    if not args.dashboard and not args.input:
        _connect()
    raise SystemExit(trace_main(argv))


def cmd_timeline(args) -> None:
    ray_tpu_torch = _connect()
    out = args.output or os.path.join(
        ROOT, f"timeline_{int(time.time())}.json")
    ray_tpu_torch.timeline(filename=out)
    print(f"Wrote Chrome trace to {out}")


def cmd_submit(args) -> None:
    env = dict(os.environ)
    env["RAY_TPU_TORCH_ADDRESS"] = args.address or _default_address()
    raise SystemExit(subprocess.call(
        [sys.executable, args.script] + args.script_args, env=env))


def cmd_microbenchmark(args) -> None:
    from ray_tpu_torch.scripts.perf import main as perf_main
    perf_main(device=args.device)


def _job_client(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient
    addr = getattr(args, "address", None)
    if addr is None and not os.environ.get("RAY_TPU_TORCH_DASHBOARD_ADDRESS"):
        os.environ.setdefault("RAY_TPU_TORCH_SESSION_DIR", _default_address())
    return JobSubmissionClient(addr)


def cmd_job(args) -> None:
    """`cli job ...` — REST job API (reference: `ray job` CLI,
    dashboard/modules/job/cli.py)."""
    import shlex
    client = _job_client(args)
    if args.job_cmd == "submit":
        jid = client.submit_job(
            # shlex.join keeps each argv element intact through the job
            # manager's `sh -c` re-parse (plain join would corrupt
            # arguments with spaces/quotes)
            entrypoint=shlex.join(args.entrypoint),
            runtime_env=json.loads(args.runtime_env)
            if args.runtime_env else None,
            priority=args.priority, elastic=args.elastic)
        print(jid)
        if not args.no_wait:
            try:
                status = client.wait_until_status(
                    jid, timeout_s=args.timeout)
            except TimeoutError:
                print(f"Job {jid} still running after {args.timeout}s "
                      f"(check later with `cli job status {jid}`)")
                raise SystemExit(2)
            sys.stdout.write(client.get_job_logs(jid))
            print(f"Job {jid}: {status}")
            raise SystemExit(0 if status == "SUCCEEDED" else 1)
    elif args.job_cmd == "list":
        print(json.dumps(client.list_jobs(), indent=2, default=str))
        try:
            arb = client.get_arbiter_status()
        except RuntimeError:
            arb = None   # head runs without an arbiter: section
        if arb and arb.get("rows"):
            print("-- slice arbitration "
                  f"(pressure={'yes' if arb.get('pressure') else 'no'},"
                  f" preemptions={arb.get('preemptions', 0)},"
                  f" returns={arb.get('returns', 0)}) --")
            for r in arb["rows"]:
                print(f"  {r['slice_id']}  {r['kind']:<5}  "
                      f"prio={r['priority']:<3} {r['state']:<9} "
                      f"owner={r['owner']}  {r['why']}")
    elif args.job_cmd == "status":
        print(client.get_job_status(args.submission_id))
    elif args.job_cmd == "logs":
        sys.stdout.write(client.get_job_logs(args.submission_id))
    elif args.job_cmd == "stop":
        print(client.stop_job(args.submission_id))


def _cluster_config(args) -> str:
    path = getattr(args, "config_opt", None) or args.config
    if not path:
        raise SystemExit("a cluster YAML is required "
                         "(cli up --config cluster.yaml)")
    return path


def cmd_up(args) -> None:
    """Create/bootstrap a cluster from YAML (reference: `ray up`,
    commands.py:create_or_update_cluster). Fake providers
    (`type: fake_slice`) get the local round-trip: head daemon + every
    slice's host VMs as local node-manager processes."""
    from ray_tpu_torch.autoscaler.launcher import (
        load_cluster_config, make_launcher)
    cfg = load_cluster_config(_cluster_config(args))
    if not args.yes:
        ans = input(f"Launch cluster {cfg['cluster_name']!r} "
                    f"({cfg['provider']['type']})? [y/N] ")
        if ans.strip().lower() not in ("y", "yes"):
            print("aborted")
            return
    out = make_launcher(cfg).up()
    print(json.dumps(out))


def cmd_down(args) -> None:
    from ray_tpu_torch.autoscaler.launcher import (
        load_cluster_config, make_launcher)
    cfg = load_cluster_config(_cluster_config(args))
    if not args.yes:
        ans = input(f"Tear down cluster {cfg['cluster_name']!r}? [y/N] ")
        if ans.strip().lower() not in ("y", "yes"):
            print("aborted")
            return
    out = make_launcher(cfg).down(keep_head=args.keep_head)
    if isinstance(out, list):  # ClusterLauncher returns the node list
        out = {"terminated": out}
    print(json.dumps(out))


def cmd_attach(args) -> None:
    import subprocess as sp_mod
    from ray_tpu_torch.autoscaler.launcher import (
        ClusterLauncher, load_cluster_config)
    cfg = load_cluster_config(args.config)
    cmd = ClusterLauncher(cfg).attach_command()
    if args.dry_run:
        print(" ".join(cmd))
        return
    sp_mod.run(cmd)


def main() -> None:
    p = argparse.ArgumentParser(prog="python -m ray_tpu_torch.scripts.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="start head or worker node")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", default=None)
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=float, default=None)
    sp.add_argument("--resources", default=None)
    sp.add_argument("--labels", default=None,
                    help="k=v,k2=v2 node labels (worker mode)")
    sp.add_argument("--initial-workers", type=int, default=2)
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop the head started here")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("status", help="cluster resource summary")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("list", help="list cluster state")
    sp.add_argument("what", choices=[
        "actors", "tasks", "objects", "nodes", "placement_groups",
        "jobs", "workers"])
    sp.add_argument("--filter", action="append")
    sp.add_argument("--limit", type=int, default=100)
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("summary", help="summarize cluster state")
    sp.add_argument("what", choices=["tasks", "actors", "objects"])
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("memory", help="object store summary")
    sp.set_defaults(fn=cmd_memory)

    sp = sub.add_parser("timeline", help="dump Chrome trace")
    sp.add_argument("--output", default=None)
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser(
        "trace", help="render a serve request's trace waterfall")
    sp.add_argument("request_id", nargs="?", default=None,
                    help="request id (X-Request-Id header / 429 body; "
                    "omit to list the captured tail)")
    sp.add_argument("--dashboard", default=None,
                    help="dashboard address (defaults to the running "
                    "session's)")
    sp.add_argument("--input", default=None,
                    help="waterfall JSON dump instead of a live "
                    "cluster")
    sp.add_argument("--perfetto", default=None, metavar="OUT",
                    help="also export Chrome-trace JSON")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser("top", help="live fleet metrics view")
    sp.add_argument("--dashboard", default=None,
                    help="dashboard address (defaults to the running "
                    "session's)")
    sp.add_argument("--once", action="store_true",
                    help="print one snapshot and exit")
    sp.add_argument("--interval", type=float, default=2.0)
    sp.add_argument("--window", type=float, default=30.0)
    sp.set_defaults(fn=cmd_top)

    sp = sub.add_parser("submit", help="run a script against the cluster")
    sp.add_argument("script")
    sp.add_argument("script_args", nargs="*")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_submit)

    sp = sub.add_parser("up", help="launch a cluster from YAML config")
    sp.add_argument("config", nargs="?", default=None)
    sp.add_argument("--config", dest="config_opt", default=None,
                    help="cluster YAML (alias of the positional)")
    sp.add_argument("-y", "--yes", action="store_true")
    sp.set_defaults(fn=cmd_up)

    sp = sub.add_parser("down", help="tear down a YAML-config cluster")
    sp.add_argument("config", nargs="?", default=None)
    sp.add_argument("--config", dest="config_opt", default=None,
                    help="cluster YAML (alias of the positional)")
    sp.add_argument("-y", "--yes", action="store_true")
    sp.add_argument("--keep-head", action="store_true")
    sp.set_defaults(fn=cmd_down)

    sp = sub.add_parser("attach", help="ssh to the cluster head")
    sp.add_argument("config")
    sp.add_argument("--dry-run", action="store_true",
                    help="print the ssh command instead of running it")
    sp.set_defaults(fn=cmd_attach)

    sp = sub.add_parser("microbenchmark", help="core perf suite")
    sp.add_argument("--device", default=None,
                    help="the PPO phase's learner (default: the card)")
    sp.set_defaults(fn=cmd_microbenchmark)

    sp = sub.add_parser("job", help="job submission REST API")
    jsub = sp.add_subparsers(dest="job_cmd", required=True)
    jp = jsub.add_parser("submit", help="submit an entrypoint command")
    jp.add_argument("entrypoint", nargs="+")
    jp.add_argument("--address", default=None)
    jp.add_argument("--runtime-env", default=None,
                    help='JSON, e.g. {"env_vars": {"K": "V"}}')
    jp.add_argument("--priority", default="normal",
                    choices=["low", "normal", "high"],
                    help="slice-arbitration priority: under serve "
                    "pressure the lowest-priority training job's "
                    "slice is preempted first")
    jp.add_argument("--elastic", action="store_true",
                    help="driver survives losing a slice mid-run "
                    "(ElasticTrainer re-lowers instead of dying)")
    jp.add_argument("--no-wait", action="store_true")
    jp.add_argument("--timeout", type=float, default=600.0)
    for name in ("status", "logs", "stop"):
        jp = jsub.add_parser(name)
        jp.add_argument("submission_id")
        jp.add_argument("--address", default=None)
    jp = jsub.add_parser("list")
    jp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_job)

    args = p.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
