"""The JAX package's ``tests/rlhf/test_weight_sync.py`` bodies on the
port's int8 wire and ``WeightPublisher`` (loaded by
``tests/test_torch_runtime_loader.py``)."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

globals().update(FIXTURES)
globals().update(load_core_tests("rlhf/test_weight_sync.py"))


def test_publisher_stages_each_engines_dtype_on_its_device():
    """An in-process port engine receives tensors in its own dtypes on
    its device (bf16 matrices, f32 norms) through ``stage_weights``, and
    ``publish`` returns once the engine reports the new version."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import TransformerConfig

    class _Engine:
        device = torch.device("cpu")
        model_config = TransformerConfig(vocab_size=8, d_model=4,
                                         dtype=torch.bfloat16)

        _dead = None

        def __init__(self):
            self.staged = []
            self.polls = 0

        def stage_weights(self, params, version):
            self.staged.append((params, version))

        def stats(self):            # the swap lands on the second poll
            self.polls += 1
            return {"weight_version": self.staged[-1][1]
                    if self.polls > 1 else 0}

    a, b = _Engine(), _Engine()
    pub = WeightPublisher([a, b], block_size=8)
    tree = {"embed": np.ones((8, 4), np.float32),
            "final_norm": {"scale": np.ones(4, np.float32)}}
    assert pub.publish(tree) == 1
    (pa, va), (pb, vb) = a.staged[0], b.staged[0]
    assert va == vb == 1
    assert pa["embed"].dtype == torch.bfloat16
    assert pa["final_norm"]["scale"].dtype == torch.float32
    assert pa is pb              # engines alike share one staged tree
    assert a.polls == b.polls == 2
    st = pub.stats()
    assert st["pack_wall_s"] >= 0 and st["unpack_wall_s"] >= 0
