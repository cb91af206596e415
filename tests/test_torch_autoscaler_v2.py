"""``ray_tpu_torch.autoscaler.v2`` on the CPU: the JAX package's
``tests/autoscaler/test_autoscaler_v2.py`` bodies on the port (loaded by
``tests/test_torch_runtime_loader.py``), and the port's ``AutoscalerV2``
against the JAX one: each over an in-memory provider and a stub
controller fed one seeded demand sequence, their launch and terminate
decisions, instance states and transition histories are equal at every
pass (instance ids aside), and their ``ResourceDemandScheduler``s decide
alike over seeded demands."""

import numpy as np
import pytest

from test_torch_runtime_loader import FIXTURES, load_core_tests

globals().update(FIXTURES)
globals().update(load_core_tests("autoscaler/test_autoscaler_v2.py"))


class MemProvider:
    """Nodes that exist once created: a host id each, joined one pass
    after creation."""

    def __init__(self):
        self.nodes, self.n = {}, 0

    def non_terminated_nodes(self):
        return list(self.nodes)

    def node_type(self, pid):
        return self.nodes[pid]["type"]

    def create_node(self, node_type, resources):
        self.n += 1
        pid = f"node-{self.n}"
        self.nodes[pid] = {"type": node_type, "host": f"host-{self.n}"}
        return pid

    def terminate_node(self, pid):
        self.nodes.pop(pid, None)

    def internal_ids(self, pid):
        return [self.nodes[pid]["host"]] if pid in self.nodes else []

    def expected_internal_count(self, pid):
        return 1


class StubController:
    def __init__(self):
        self.snap = {"demand": [], "busy_nodes": set(),
                     "alive_nodes": set()}

    def call_on_loop(self, fn, timeout=None):
        return fn()


def _types(mod):
    return [mod.NodeTypeConfig("small", {"CPU": 2}, min_workers=1,
                               max_workers=3),
            mod.NodeTypeConfig("big", {"CPU": 8, "GPU": 1},
                               min_workers=0, max_workers=2)]


def _seeded_demand(rng):
    return [{"CPU": float(rng.choice([1, 2, 4]))}
            if rng.random() < 0.7 else {"CPU": 1.0, "GPU": 1.0}
            for _ in range(int(rng.integers(0, 6)))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_v2_reconciles_as_the_jax_one_over_a_seeded_demand(seed,
                                                          monkeypatch):
    import ray_tpu.autoscaler as jauto
    import ray_tpu.autoscaler.autoscaler as jscaler
    import ray_tpu.autoscaler.v2 as jv2
    import ray_tpu_torch.autoscaler as pauto
    import ray_tpu_torch.autoscaler.autoscaler as pscaler
    import ray_tpu_torch.autoscaler.v2 as pv2
    rigs = {}
    for name, auto, scaler, v2 in (("jax", jauto, jscaler, jv2),
                                   ("port", pauto, pscaler, pv2)):
        ctrl, prov = StubController(), MemProvider()
        monkeypatch.setattr(scaler, "collect_demand_snapshot",
                            lambda c: dict(c.snap))
        monkeypatch.setattr(scaler, "drain_nodes_if_idle",
                            lambda c, ids: not (set(ids)
                                                & c.snap["busy_nodes"]))
        rigs[name] = (v2.AutoscalerV2(ctrl, prov, _types(auto),
                                      idle_timeout_s=0.0), ctrl, prov)
    rng = np.random.default_rng(seed)
    launched = 0
    for t in range(60):
        demand = _seeded_demand(rng) if (t // 10) % 2 == 0 else []
        busy_share = float(rng.random())
        got = {}
        for name, (scaler, ctrl, prov) in rigs.items():
            hosts = [h for pid in prov.nodes for h in prov.internal_ids(pid)]
            ctrl.snap = {"demand": demand, "alive_nodes": set(hosts),
                         "busy_nodes": set(hosts[:int(len(hosts)
                                                      * busy_share)])}
            out = scaler.update()
            order = {iid: k for k, iid in enumerate(
                i.instance_id for i in scaler.storage.list())}
            got[name] = {
                "launched": [order[i] for i in out["launched"]],
                "terminated": [order[i] for i in out["terminated"]],
                "instances": [(order[i], s)
                              for i, s in out["instances"].items()],
                "history": [(order[i.instance_id], i.node_type, i.history,
                             i.provider_node_id)
                            for i in scaler.storage.list()]}
        assert got["port"] == got["jax"], t
        launched += len(got["port"]["launched"])
    assert launched >= 3
    assert any(s == "TERMINATED" for _, s in got["port"]["instances"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_demand_scheduler_decides_as_the_jax_one(seed):
    import ray_tpu.autoscaler as jauto
    import ray_tpu.autoscaler.v2 as jv2
    import ray_tpu_torch.autoscaler as pauto
    import ray_tpu_torch.autoscaler.v2 as pv2
    rng = np.random.default_rng(seed)
    scheds = {name: v2.ResourceDemandScheduler(
        {t.name: t for t in _types(auto)})
        for name, auto, v2 in (("jax", jauto, jv2), ("port", pauto, pv2))}
    for _ in range(50):
        demand = _seeded_demand(rng)
        states = [str(rng.choice(["QUEUED", "REQUESTED", "ALLOCATED",
                                  "RAY_RUNNING", "TERMINATED"]))
                  for _ in range(int(rng.integers(0, 5)))]
        types = [str(rng.choice(["small", "big"])) for _ in states]
        idle = [f"n{k}" for k in range(len(states)) if rng.random() < 0.5]
        out = {}
        for name, v2 in (("jax", jv2), ("port", pv2)):
            insts = [v2.Instance(f"i{k}", ty, status=st,
                                 provider_node_id=f"n{k}")
                     for k, (ty, st) in enumerate(zip(types, states))]
            out[name] = scheds[name].schedule(demand, insts, idle)
        assert out["port"] == out["jax"]
