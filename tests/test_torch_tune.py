"""The JAX package's ``tests/tune/test_tune.py``,
``tests/tune/test_callbacks.py`` and ``tests/tune/test_new_schedulers.py``
bodies on the port (loaded by ``tests/test_torch_runtime_loader.py``):
variants and search spaces, a function and a class trainable through
``Tuner``, ASHA, the median stopping rule, PBT's exploits, restore, a
trial's retry, ``with_parameters``/``with_resources`` through
``tune.run``, a ``DataParallelTrainer`` tuned over its trial's placement
group, the callbacks and loggers, PB2, BOHB, HyperBand, the
resource-changing scheduler and the optional searchers (driven through
fakes of their packages, and gated where the packages are missing), and
the experiment-tracking integrations gated where wandb, mlflow and
comet_ml are missing.

``DistributeResources`` splits ``GPU`` where the JAX package splits
``TPU``: its body runs with the two names swapped. The callbacks file's
own 4-CPU runtime is left out: its body runs on the 8-CPU runtime the
others share.
"""

from test_torch_runtime_loader import FIXTURES, load_core_tests, ray_session

LEAVE_OUT_CALLBACKS = {
    "ray_session": "the bodies share the loader's 8-CPU runtime",
}
#: the port's DistributeResources splits GPU where the JAX one splits TPU
GPU_FOR_TPU = [("DistributeResources(total_cpus=8, total_tpus=4)",
                "DistributeResources(total_cpus=8, total_gpus=4)"),
               ('{"CPU": 2.0, "TPU": 1.0}', '{"CPU": 2.0, "GPU": 1.0}'),
               ('{"CPU": 4.0, "TPU": 2.0}', '{"CPU": 4.0, "GPU": 2.0}')]

globals().update(FIXTURES)
globals().update(load_core_tests("tune/test_tune.py"))
globals().update(load_core_tests("tune/test_callbacks.py",
                                 LEAVE_OUT_CALLBACKS))
globals().update(load_core_tests("tune/test_new_schedulers.py",
                                 edits=GPU_FOR_TPU))
globals()["ray_session"] = ray_session
