"""Deployment + Application: the Serve authoring API.

Reference: ``python/ray/serve/deployment.py`` (``@serve.deployment``)
and ``serve/_private/deployment_graph_build.py`` — a Deployment wraps a
class/function with replica/autoscaling config; ``.bind(*args)``
produces an Application node whose arguments may themselves be bound
deployments (model composition: inner deployments become
DeploymentHandles at init time).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union


@dataclasses.dataclass
class AutoscalingConfig:
    """Queue-depth autoscaling (reference ``serve/config.py``).

    Beyond the reference's ongoing-request target, engine-aware
    deployments (those whose instance exposes ``stats()`` — e.g.
    ``LLMServer``) can scale up on the per-replica engine gauges: a
    mean engine queue depth above ``target_queue_depth``, or a mean
    time-to-first-token above ``target_ttft_s``, triggers the same
    scale-up path as ongoing-request pressure. Both default to None
    (off) so plain deployments behave exactly as before; engine
    pressure also vetoes a downscale (an idle handle count can
    coexist with a deep engine backlog — continuous batching hides
    queued work from the ongoing-request signal).
    """
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 10.0
    #: scale up when mean engine queue depth exceeds this (None = off)
    target_queue_depth: Optional[float] = None
    #: scale up when mean engine TTFT (EWMA) exceeds this (None = off)
    target_ttft_s: Optional[float] = None


class Deployment:
    def __init__(self, func_or_class, name: str,
                 num_replicas: Optional[Union[int, str]] = None,
                 autoscaling_config: Optional[dict] = None,
                 ray_actor_options: Optional[dict] = None,
                 max_ongoing_requests: int = 100,
                 user_config: Optional[Any] = None,
                 health_check_period_s: float = 10.0,
                 version: Optional[str] = None,
                 migrate_prefixes: bool = False):
        self.func_or_class = func_or_class
        self.name = name
        if isinstance(autoscaling_config, dict):
            autoscaling_config = AutoscalingConfig(**autoscaling_config)
        if num_replicas == "auto" and autoscaling_config is None:
            autoscaling_config = AutoscalingConfig()
        self.autoscaling_config = autoscaling_config
        self.num_replicas = (autoscaling_config.min_replicas
                             if autoscaling_config else
                             (num_replicas if isinstance(num_replicas, int)
                              else 1))
        self.ray_actor_options = ray_actor_options or {}
        self.max_ongoing_requests = max_ongoing_requests
        self.user_config = user_config
        self.health_check_period_s = health_check_period_s
        self.version = version
        #: drain-time warm-prefix migration: before the controller
        #: kills a replica on downscale, its warm radix-trie KV chains
        #: are exported (``Replica.prepare_drain``) and adopted by a
        #: surviving replica, so the fleet's prefix hit rate survives
        #: the drain (serve/disagg.py::migrate_warm_prefixes)
        self.migrate_prefixes = migrate_prefixes

    def options(self, **kwargs) -> "Deployment":
        merged = dict(
            func_or_class=self.func_or_class, name=self.name,
            num_replicas=self.num_replicas,
            autoscaling_config=self.autoscaling_config,
            ray_actor_options=self.ray_actor_options,
            max_ongoing_requests=self.max_ongoing_requests,
            user_config=self.user_config,
            health_check_period_s=self.health_check_period_s,
            version=self.version,
            migrate_prefixes=self.migrate_prefixes)
        merged.update(kwargs)
        return Deployment(**merged)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name})"


class Application:
    """A bound deployment DAG node (reference ``Application``)."""

    def __init__(self, deployment: Deployment, args: Tuple, kwargs: Dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs

    def _collect(self, seen: Dict[str, "Application"]) -> None:
        """Topologically collect all deployments in this app DAG."""
        for arg in list(self.init_args) + list(self.init_kwargs.values()):
            if isinstance(arg, Application):
                arg._collect(seen)
        seen[self.deployment.name] = self


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: Optional[Union[int, str]] = None,
               autoscaling_config: Optional[dict] = None,
               ray_actor_options: Optional[dict] = None,
               max_ongoing_requests: int = 100,
               user_config: Optional[Any] = None,
               health_check_period_s: float = 10.0,
               version: Optional[str] = None,
               migrate_prefixes: bool = False):
    """``@serve.deployment`` (reference ``api.py``)."""
    def wrap(fc):
        return Deployment(
            fc, name or fc.__name__, num_replicas=num_replicas,
            autoscaling_config=autoscaling_config,
            ray_actor_options=ray_actor_options,
            max_ongoing_requests=max_ongoing_requests,
            user_config=user_config,
            health_check_period_s=health_check_period_s,
            version=version,
            migrate_prefixes=migrate_prefixes)
    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
