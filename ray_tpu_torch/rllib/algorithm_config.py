"""AlgorithmConfig: fluent RL configuration, a copy of
``ray_tpu/rllib/algorithm_config.py``.

Reference: ``rllib/algorithms/algorithm_config.py`` — chained
``.environment().env_runners().training().learners()`` calls producing
the Algorithm. ``build()`` returns the ready Algorithm instance. The
port adds one setting, ``learners(device=...)``: the local learner's
device, ``None`` (the card) unless a caller names another, as tests name
the CPU.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[type] = None):
        self.algo_class = algo_class
        # environment
        self.env: Any = None
        self.env_config: Dict[str, Any] = {}
        # env runners
        self.num_env_runners: int = 0
        self.num_envs_per_env_runner: int = 1
        self.rollout_fragment_length: int = 200
        #: stream rollout blocks from generator-task runners straight
        #: into the learner (rollout_stream.py) instead of the
        #: epoch-barriered sample-then-train step. Lineage-replayable:
        #: a runner SIGKILLed mid-epoch replays its stream prefix.
        self.streaming_rollouts: bool = False
        #: env steps per streamed rollout block (per runner)
        self.rollout_block_steps: int = 64
        # training
        self.lr: float = 3e-4
        self.gamma: float = 0.99
        self.train_batch_size: int = 4000
        self.minibatch_size: Optional[int] = 128
        self.num_epochs: int = 8
        self.grad_clip: Optional[float] = 0.5
        self.model: Dict[str, Any] = {"fcnet_hiddens": (64, 64)}
        # learners
        self.num_learners: int = 0
        #: the local learner's device (None: the card)
        self.learner_device: Any = None
        # debugging
        self.seed: int = 0

    # -- fluent sections (each returns self) ---------------------------
    def environment(self, env=None, *, env_config: Optional[dict] = None
                    ) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = env_config
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    streaming_rollouts: Optional[bool] = None,
                    rollout_block_steps: Optional[int] = None,
                    **_ignored) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if streaming_rollouts is not None:
            self.streaming_rollouts = streaming_rollouts
        if rollout_block_steps is not None:
            self.rollout_block_steps = rollout_block_steps
        return self

    # Reference alias
    rollouts = env_runners

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 train_batch_size: Optional[int] = None,
                 minibatch_size: Optional[int] = None,
                 num_epochs: Optional[int] = None,
                 grad_clip: Optional[float] = None,
                 model: Optional[dict] = None,
                 **kwargs) -> "AlgorithmConfig":
        for name, v in dict(lr=lr, gamma=gamma,
                            train_batch_size=train_batch_size,
                            minibatch_size=minibatch_size,
                            num_epochs=num_epochs,
                            grad_clip=grad_clip).items():
            if v is not None:
                setattr(self, name, v)
        if model is not None:
            self.model.update(model)
        for k, v in kwargs.items():  # algo-specific knobs
            setattr(self, k, v)
        return self

    def learners(self, *, num_learners: Optional[int] = None,
                 device: Any = None, **_ignored) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if device is not None:
            self.learner_device = device
        return self

    def debugging(self, *, seed: Optional[int] = None,
                  **_ignored) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def resources(self, **_ignored) -> "AlgorithmConfig":
        return self

    def framework(self, *_a, **_k) -> "AlgorithmConfig":
        return self  # always PyTorch here

    # -- build ----------------------------------------------------------
    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in vars(self).items()
                if k != "algo_class"}

    def build(self):
        if self.algo_class is None:
            raise ValueError("No algo_class bound to this config")
        return self.algo_class(config=self)
