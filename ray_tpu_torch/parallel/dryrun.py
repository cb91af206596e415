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
the step count. At n >= 8 it then runs the JAX dry run's other parts
(``_dryrun_ep_pp``): one step of ``moe-tiny`` with its experts sharded on
``dp 2 x ep 2 x tp 2``, and a 4-stage GPipe ``pipeline_apply`` of
``tanh(h @ w)`` stages over ``MeshSpec(pp=4, dp=2)``, forward and the
gradient of ``sum(out ** 2)``. It returns the body's losses as a
:class:`DryRun`, whose ``parts`` keep every part's per-rank results.
"""

from __future__ import annotations

import os
from typing import Any, List

from ray_tpu_torch.parallel.mesh import MeshSpec

RANK_TIMEOUT_S = 600.0


class DryRun(list):
    """The body's per-rank losses; ``parts`` maps each part that ran
    ("body", "ep", "pp") to its per-rank results."""

    def __init__(self, parts: dict):
        super().__init__(parts["body"])
        self.parts = parts


#: the pp part's shapes (``_dryrun_ep_pp``): 4 stages of 16 x 16, a
#: batch of 8 rows in 4 microbatches
PP_STAGES, PP_WIDTH, PP_ROWS, PP_MICROBATCHES = 4, 16, 8, 4


def pp_part_inputs(seed: int = 3):
    """The pp part's stage weights ``[4, 16, 16]`` (0.3 x N(0, 1)) and
    input ``[8, 16]``, numpy f32 from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.standard_normal((PP_STAGES, PP_WIDTH, PP_WIDTH))
         ).astype(np.float32)
    x = rng.standard_normal((PP_ROWS, PP_WIDTH)).astype(np.float32)
    return w, x


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


def _dryrun_pp(rank):
    """One rank of the dry run's pp part: the GPipe pipeline over
    ``MeshSpec(pp=4, dp=2)`` (every rank at n = 8), ``tanh(h @ w)``
    stages, forward and the gradient of ``sum(out ** 2)`` with respect
    to this rank's stage weight. Returns ``(loss, [1, 16, 16] grad)``."""
    import torch

    from ray_tpu_torch.ops.pipeline import pipeline_apply
    from ray_tpu_torch.parallel.mesh import axis_group, build_mesh
    w, x = pp_part_inputs()
    mesh = build_mesh(MeshSpec(pp=PP_STAGES, dp=-1), device_type="cpu")
    s = axis_group(mesh, "pp").rank
    mine = {"w": torch.tensor(w[s:s + 1]).requires_grad_()}
    out = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), mine,
                         torch.tensor(x), mesh, PP_MICROBATCHES)
    loss = (out ** 2).sum()
    loss.backward()
    g = mine["w"].grad
    if not (torch.isfinite(loss) and torch.isfinite(g).all()):
        raise RuntimeError(f"dry run pp part: loss {float(loss)}")
    return float(loss), g.numpy()


def dryrun_multichip(n_devices: int) -> DryRun:
    """Validate the full sharded train step on ``n_devices`` gloo ranks on
    the CPU; returns each rank's loss (a :class:`DryRun`). Starts a
    runtime on the CPU platform when none is running (and shuts it down
    after). At ``n_devices >= 8`` the ep and pp parts follow the body; a
    part whose ranks disagree raises."""
    import ray_tpu_torch
    own = not ray_tpu_torch.is_initialized()
    platform = os.environ.get("RAY_TPU_TORCH_PLATFORM")
    if own:     # the workers the runtime starts stay off every card
        os.environ["RAY_TPU_TORCH_PLATFORM"] = "cpu"
        ray_tpu_torch.init(num_cpus=n_devices, _num_initial_workers=0)
    actors = []
    try:
        actors = start_ranks(n_devices, "gloo", group_name="dryrun")
        parts = {"body": run_on_ranks(actors, _dryrun_body, n_devices)}
        if n_devices >= 8:
            parts["ep"] = run_on_ranks(actors, _dryrun_ep)
            parts["pp"] = [(loss, g.copy()) for loss, g in
                           run_on_ranks(actors, _dryrun_pp)]
    finally:
        stop_ranks(actors)
        if own:
            ray_tpu_torch.shutdown()
            if platform is None:
                os.environ.pop("RAY_TPU_TORCH_PLATFORM", None)
            else:
                os.environ["RAY_TPU_TORCH_PLATFORM"] = platform
    for name in ("body", "ep"):
        if name in parts and len(set(parts[name])) != 1:
            raise RuntimeError(f"dry run {name}: ranks disagree on the "
                               f"loss: {parts[name]}")
    if "pp" in parts and len({loss for loss, _ in parts["pp"]}) != 1:
        raise RuntimeError(f"dry run pp part: ranks disagree on the loss: "
                           f"{[loss for loss, _ in parts['pp']]}")
    return DryRun(parts)
