"""The dry run of the full sharded train step on n gloo ranks on the
CPU: the port's twin of ``__graft_entry__.py::dryrun_multichip``,
``_dryrun_body`` and ``_factor_mesh``.

Ranks are actors of the port's runtime, one process each
(:func:`start_ranks`): ``create_collective_group`` makes each join the
default ``torch.distributed`` group through ``init_torch_distributed``
(rank 0's ``TCPStore`` address travels through the runtime's KV), and
:func:`run_on_ranks` runs one function on every rank at once through the
runtime's generic actor call. The same helpers start the card's ranks
(``num_gpus`` a fraction of one card each, backend ``"gloo"``).

:func:`dryrun_multichip` builds the mesh :func:`factor_mesh` gives, runs
one step of ``make_train_step`` at ``gptj-tiny`` over it on every rank
(at n >= 8 the mesh has ``sp = 2``: the ring) and checks the loss and
the step count. At n >= 8 it then runs the JAX dry run's ep part
(``_dryrun_ep_pp``): one step of ``moe-tiny`` with its experts sharded on
``dp 2 x ep 2 x tp 2``. Its pp part (the GPipe ``pipeline_apply``) is
ROADMAP Queue 1 item 9: there :func:`dryrun_multichip` raises
:class:`DryRunIncomplete`, which carries the losses of the parts that
ran.
"""

from __future__ import annotations

import os
from typing import Any, List

from ray_tpu_torch.parallel.mesh import MeshSpec

RANK_TIMEOUT_S = 600.0


class DryRunIncomplete(NotImplementedError):
    """The dry run reached a part the port does not have yet; ``results``
    holds each finished part's per-rank losses."""

    def __init__(self, message: str, results: dict):
        super().__init__(message)
        self.results = results


def factor_mesh(n: int) -> MeshSpec:
    """Split n devices over (dp, fsdp, sp, tp), preferring to exercise
    every parallelism kind the device count allows (``_factor_mesh``)."""
    sizes = {"fsdp": 1, "tp": 1, "sp": 1, "dp": 1}
    rem = n
    for axis in ("fsdp", "tp", "sp"):
        if rem % 2 == 0 and rem > 1:
            sizes[axis] *= 2
            rem //= 2
    sizes["dp"] = rem
    return MeshSpec(**sizes)


class Rank:
    """A rank process (one CPU thread for torch's own ops, so that ranks
    sharing a host do not oversubscribe it): holds what the functions
    run on it leave on it."""

    def __init__(self):
        import torch
        torch.set_num_threads(1)
        self.state: dict = {}


def start_ranks(n: int, backend: str, group_name: str = "ranks",
                num_gpus: float = 0.0) -> List[Any]:
    """``n`` rank actors (one CPU and ``num_gpus`` each) joined into the
    default ``torch.distributed`` group of ``backend`` (named
    ``group_name`` in the collective layer), rank ``i`` the ``i``-th
    handle. Needs a running runtime."""
    import ray_tpu_torch
    from ray_tpu_torch.parallel.collective import create_collective_group
    cls = ray_tpu_torch.remote(num_cpus=1, num_gpus=num_gpus)(Rank)
    actors = [cls.remote() for _ in range(n)]
    try:
        create_collective_group(actors, n, list(range(n)), backend,
                                group_name)
    except BaseException:
        stop_ranks(actors)
        raise
    return actors


def run_on_ranks(actors: List[Any], fn, *args) -> List[Any]:
    """``fn(rank_actor, *args)`` on every rank at once; the results in
    rank order. A failure on any rank raises."""
    import ray_tpu_torch
    return ray_tpu_torch.get([a.__ray_call__.remote(fn, *args)
                              for a in actors], timeout=RANK_TIMEOUT_S)


def stop_ranks(actors: List[Any]) -> None:
    import ray_tpu_torch
    for a in actors:
        ray_tpu_torch.kill(a)


def _one_step(spec, name: str, batch_size: int, seed: int) -> float:
    """One ``make_train_step`` step of ``name`` over ``spec`` on this
    rank (the CPU); returns its loss, checked positive."""
    import numpy as np

    from ray_tpu_torch.models import get_config, make_train_step
    from ray_tpu_torch.parallel.mesh import build_mesh
    from ray_tpu_torch.parallel.sharding import FSDP_RULES

    mesh = build_mesh(spec, device_type="cpu")
    cfg = get_config(name)
    bundle = make_train_step(cfg, mesh, rules=FSDP_RULES,
                             learning_rate=1e-3, device="cpu")
    state = bundle.init(seed=0)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                               (batch_size, 32))
    state, metrics = bundle.step(state, {"input_ids": ids})
    loss = float(metrics["loss"])
    if not loss > 0.0 or int(state["step"]) != 1:
        raise RuntimeError(f"dry run step of {name} on {spec}: loss "
                           f"{loss}, step {int(state['step'])}")
    return loss


def _dryrun_body(rank, n_devices: int) -> float:
    """One rank of the dry run: returns the step's loss."""
    return _one_step(factor_mesh(n_devices), "gptj-tiny",
                     max(4, 2 * n_devices), 1)


def _dryrun_ep(rank) -> float:
    """One rank of the dry run's ep part: expert parallelism, MoE MLPs
    sharded on ep with Switch top-1 routing, over every rank (dp 2 x ep 2
    x tp 2 at n = 8, JAX's mesh on its first eight devices)."""
    return _one_step(MeshSpec(dp=-1, ep=2, tp=2), "moe-tiny", 4, 2)


def dryrun_multichip(n_devices: int) -> List[float]:
    """Validate the full sharded train step on ``n_devices`` gloo ranks on
    the CPU; returns each rank's loss. Starts a runtime on the CPU
    platform when none is running (and shuts it down after). At
    ``n_devices >= 8`` the ep part follows the body, then
    :class:`DryRunIncomplete` names the pp part."""
    import ray_tpu_torch
    own = not ray_tpu_torch.is_initialized()
    platform = os.environ.get("RAY_TPU_TORCH_PLATFORM")
    if own:     # the workers the runtime starts stay off every card
        os.environ["RAY_TPU_TORCH_PLATFORM"] = "cpu"
        ray_tpu_torch.init(num_cpus=n_devices, _num_initial_workers=0)
    actors = []
    try:
        actors = start_ranks(n_devices, "gloo", group_name="dryrun")
        body = run_on_ranks(actors, _dryrun_body, n_devices)
        if n_devices < 8:
            return body
        ep = run_on_ranks(actors, _dryrun_ep)
    finally:
        stop_ranks(actors)
        if own:
            ray_tpu_torch.shutdown()
            if platform is None:
                os.environ.pop("RAY_TPU_TORCH_PLATFORM", None)
            else:
                os.environ["RAY_TPU_TORCH_PLATFORM"] = platform
    raise DryRunIncomplete(
        "the JAX dry run's pp part (the GPipe pipeline_apply over pp) is "
        "ROADMAP Queue 1 item 9, not ported yet; the body and the ep part "
        "passed", {"body": body, "ep": ep})
