"""RLHF in the port. So far only the learner-to-engine weight refresh's
wire format (:mod:`ray_tpu_torch.rlhf.weight_sync`), which
``LLMServer.sync_weights`` reads; the rollout engine, the learners and
the trainer are still to be ported (ROADMAP Queue 1 item 7)."""

from ray_tpu_torch.rlhf.weight_sync import (pack_weights, packed_wire_bytes,
                                            unpack_weights)

__all__ = ["pack_weights", "packed_wire_bytes", "unpack_weights"]
