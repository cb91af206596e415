"""The port's cloud providers and cluster launcher against the JAX
package's, on the CPU: each JAX body of
``tests/autoscaler/test_gce_launcher.py`` and
``tests/autoscaler/test_gke_provider.py`` that drives a provider through
its mock API runs once on each package, every request either sends
(method, path and body) recorded by the mock: the sequences are equal,
node ids aside. ``validate_cluster_config`` gives the same normalized
dict, or the same error, on every config of the JAX launcher tests and
``docs/cluster.yaml``, where the port's accelerator resource is named
``GPU`` and the JAX package's ``TPU``."""

import copy
import json
import os
import re

import pytest
import yaml

from test_torch_autoscaler_arbiter import jax_module
from test_torch_runtime_loader import ROOT, load_core_tests

_GCE = "autoscaler/test_gce_launcher.py"
_GKE = "autoscaler/test_gke_provider.py"
GCE_BODIES = ["test_create_node_issues_one_slice_create",
              "test_list_filters_foreign_and_terminated_slices",
              "test_terminate_deletes_slice_and_tolerates_404",
              "test_wait_until_ready_polls_to_ready",
              "test_gang_demand_provisions_exactly_one_slice",
              "test_partial_join_is_not_idle",
              "test_up_creates_head_bootstraps_and_is_idempotent",
              "test_down_terminates_workers_then_head",
              "test_attach_command_targets_head_ip"]
GKE_BODIES = ["test_create_node_bumps_replicas_and_registers_pending",
              "test_pods_appear_and_count_hosts",
              "test_terminate_uses_workers_to_delete_protocol",
              "test_foreign_cluster_pods_invisible",
              "test_gang_demand_scales_workergroup_and_drains_down"]


def _recording(mod, mock_name: str, log: list):
    """``mod``'s mock API, each request appended to ``log``."""
    base = getattr(mod, mock_name)

    class Recording(base):
        def __call__(self, method, url, body):
            log.append((method, url, copy.deepcopy(body)))
            return super().__call__(method, url, body)
    return Recording


class _Ids:
    """Node ids (8 hex digits a provider draws) renamed in order of
    first appearance."""

    def __init__(self):
        self.seen = {}

    def __call__(self, text: str) -> str:
        def name(m):
            return self.seen.setdefault(m.group(0),
                                        f"<id{len(self.seen)}>")
        return re.sub(r"(?<=-)[0-9a-f]{8}(?![0-9a-f])", name, text)


def port_module(filename: str):
    """The JAX test module ``filename`` compiled against the port."""
    import sys
    load_core_tests(filename)
    stem = filename.replace("/", "_")[:-3]
    return sys.modules["ray_tpu_torch_port_" + stem]


def _run(mod, body: str, mock_name: str, monkeypatch):
    log = []
    monkeypatch.setattr(mod, mock_name, _recording(mod, mock_name, log))
    getattr(mod, body)()
    ids = _Ids()
    return [ids(json.dumps(rec, sort_keys=True, default=str))
            for rec in log]


@pytest.mark.parametrize("body", GCE_BODIES)
def test_gce_requests_equal_the_jax_providers(body, monkeypatch):
    jax = _run(jax_module(_GCE), body, "MockTPUApi", monkeypatch)
    port = _run(port_module(_GCE), body, "MockTPUApi", monkeypatch)
    assert port == jax and len(jax) > 0


@pytest.mark.parametrize("body", GKE_BODIES)
def test_gke_requests_equal_the_jax_providers(body, monkeypatch):
    jax = _run(jax_module(_GKE), body, "MockK8s", monkeypatch)
    port = _run(port_module(_GKE), body, "MockK8s", monkeypatch)
    assert port == jax and len(jax) > 0


def _launcher_configs():
    """(name, config) of every config the JAX launcher tests validate,
    ``docs/cluster.yaml`` among them, in the JAX package's names."""
    gce = jax_module(_GCE)
    lc = jax_module("autoscaler/test_launcher_config.py")
    out = [("docs/cluster.yaml",
            yaml.safe_load((ROOT / "docs" / "cluster.yaml").read_text())),
           ("gce good_config", gce.good_config())]
    for k, (mutate, _) in enumerate([
            (lambda c: c.pop("cluster_name"), 0),
            (lambda c: c["provider"].pop("project"), 0),
            (lambda c: c.update(head_node_type="nope"), 0),
            (lambda c: c["available_node_types"]["v5e_64"].update(
                min_workers=9), 0),
            (lambda c: c["available_node_types"]["v5e_64"]["resources"]
             .update(TPU=-1), 0),
            (lambda c: c.update(setup_commands="oops"), 0)]):
        cfg = gce.good_config()
        mutate(cfg)
        out.append((f"gce rejected {k}", cfg))
    for name, slices in [
            ("slices default", {"pod": {"topology": "4x4"}}),
            ("slices topology", {"pod": {"topology": "5x5"}}),
            ("slices bundles", {"pod": {"topology": "2x2", "placement": {
                "strategy": "SLICE_SPREAD",
                "bundles": [{"TPU": 4}] * 3}}}),
            ("slices pack", {"pod": {"topology": "2x4", "host_resources":
                                     {"CPU": 2, "TPU": 4},
                                     "placement": {"strategy": "SLICE_PACK",
                                                   "bundles": [{"TPU": 8}]}}}),
            ("slices bounds", {"pod": {"topology": "4x4", "count": 5,
                                       "max_slices": 2}})]:
        out.append((name, lc._base(slices)))
    arb = lc._base({"pod": {"topology": "2x2"}})
    arb["arbiter"] = {"queue_high": 8, "sustain_s": 1.5, "max_borrowed": 2}
    out.append(("arbiter", arb))
    bad = copy.deepcopy(arb)
    bad["arbiter"]["nope"] = 1
    out.append(("arbiter unknown knob", bad))
    return out


def _gpu(obj):
    """The config with its accelerator resource named as the port's."""
    return json.loads(re.sub(r"\bTPU\b", "GPU", json.dumps(obj)))


@pytest.mark.parametrize("name,cfg", _launcher_configs(),
                         ids=[n for n, _ in _launcher_configs()])
def test_the_launcher_validates_as_the_jax_one(name, cfg):
    from ray_tpu.autoscaler import launcher as jl
    from ray_tpu_torch.autoscaler import launcher as pl

    def validate(mod, c):
        try:
            return ("ok", mod.validate_cluster_config(copy.deepcopy(c)))
        except mod.ConfigError as e:
            return ("error", str(e))
    want = validate(jl, cfg)
    got = validate(pl, _gpu(cfg))
    assert _gpu(got) == _gpu(want), name
