"""``ray_tpu_torch.autoscaler.arbiter`` on the CPU: the JAX package's
``tests/autoscaler/test_arbiter.py`` bodies on the port (loaded by
``tests/test_torch_runtime_loader.py``; every one, with
``test_gauges_fall_back_to_live_metrics_plane`` on the port's live
metrics plane), and the port's ``SliceArbiter`` against the JAX one:
both driven by one seeded gauge trace on an injected clock over their
packages' in-memory slice managers, their ``update()`` outputs,
``status()`` rows and recorded events are equal at every tick, slice ids
and timestamps aside."""

import types

import numpy as np
import pytest

from test_torch_runtime_loader import (FIXTURES, jax_test_path,
                                       load_core_tests)

globals().update(FIXTURES)
_port = load_core_tests("autoscaler/test_arbiter.py")
globals().update(_port)


def jax_module(filename: str) -> types.ModuleType:
    """The JAX package's test module ``filename``, as it is (its helpers
    build the JAX package's objects)."""
    path = jax_test_path(filename)
    mod = types.ModuleType("jax_" + path.stem)
    mod.__file__ = str(path)
    exec(compile(path.read_text(), str(path), "exec"), mod.__dict__)
    return mod


class _Ids:
    """Slice ids renamed by first appearance (each package draws its
    own)."""

    def __init__(self):
        self.names = {}

    def __call__(self, obj):
        if isinstance(obj, dict):
            return {k: self(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [self(v) for v in obj]
        if isinstance(obj, str):
            for sid in sorted(self.names, key=len, reverse=True):
                obj = obj.replace(sid, self.names[sid])
            return obj
        return obj

    def see(self, sids):
        for sid in sids:
            self.names.setdefault(sid, f"slice{len(self.names)}")


_EVENT_KEYS = ("ev", "slice", "reason", "owner", "priority", "dur_s")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_arbiter_decides_as_the_jax_one_over_a_seeded_trace(seed):
    from ray_tpu.autoscaler.arbiter import ArbiterPolicy as JPolicy
    from ray_tpu_torch.autoscaler.arbiter import ArbiterPolicy
    jmod = jax_module("autoscaler/test_arbiter.py")
    kw = dict(queue_high=4.0, queue_low=1.0, ttft_p99_high_ms=2000.0,
              ttft_p99_low_ms=1000.0, sustain_s=2.0, ebb_s=4.0,
              max_borrowed=2, min_train_slices=1)
    rigs = {"jax": jmod._rig(n_train=3, n_serve=1, policy=JPolicy(**kw)),
            "port": _port["_rig"](n_train=3, n_serve=1,
                                  policy=ArbiterPolicy(**kw))}
    ids = {k: _Ids() for k in rigs}
    rng = np.random.default_rng(seed)
    seen = {"preempt": 0, "return": 0}
    for t in range(300):
        calm = (t // 40) % 2 == 1
        q = float(rng.uniform(0, 1.0) if calm else rng.uniform(0, 9))
        p99 = float(rng.uniform(50, 900) if calm
                    else rng.uniform(100, 3000))
        dt = float(rng.choice([0.25, 0.5, 1.0]))
        busy = bool(rng.random() < 0.7)
        got = {}
        for name, (arb, mgr, prov, ctrl, clock, gauges) in rigs.items():
            gauges.queue_depth, gauges.ttft_p99_ms = q, p99
            clock.advance(dt)
            alive = {h for sid in prov.non_terminated_nodes()
                     for h in prov.internal_ids(sid)}
            mgr.update({"demand": [], "slice_demand": [],
                        "busy_nodes": alive if busy else set(),
                        "alive_nodes": alive})
            ids[name].see(sorted(mgr.slices, key=lambda s: (
                mgr.slices[s].created_at, s)))
            out = arb.update()
            ids[name].see(sorted(mgr.slices, key=lambda s: (
                mgr.slices[s].created_at, s)))
            st = arb.status()
            rows = sorted(ids[name](st["rows"]),
                          key=lambda r: (r["slice_id"], r["why"]))
            evs = [{k: e.get(k) for k in _EVENT_KEYS}
                   for e in ctrl.recorder.drain()
                   if e["ev"].startswith("ARBITER_")]
            got[name] = ids[name]((out, rows, evs, {
                k: st[k] for k in ("pressure", "pressure_reason",
                                   "borrowed", "preemptions", "returns")}))
        assert got["port"] == got["jax"], t
        for a in got["port"][0]["actions"]:
            seen["preempt" if a.startswith("preempt") else "return"] += 1
    assert seen["preempt"] >= 2 and seen["return"] >= 2, seen
    for arb, mgr, prov, *_ in rigs.values():
        mgr.shutdown()
        prov.shutdown()
