"""Models of the port: the decoder-only transformer (serving and
training paths), its train step and the named configurations."""

from ray_tpu_torch.models.registry import MODEL_CONFIGS, get_config
from ray_tpu_torch.models.training import (ClipAdamW, TrainStepBundle,
                                           default_optimizer,
                                           make_eval_step, make_train_step)
from ray_tpu_torch.models.transformer import (Transformer,
                                              TransformerConfig, apply,
                                              decode_step, hidden_states,
                                              init_kv_cache, init_params,
                                              lm_loss, prefill,
                                              remat_policy_fn,
                                              resolve_device, run_layers)

__all__ = ["ClipAdamW", "MODEL_CONFIGS", "TrainStepBundle", "Transformer",
           "TransformerConfig", "apply", "decode_step",
           "default_optimizer", "get_config", "hidden_states",
           "init_kv_cache", "init_params", "lm_loss", "make_eval_step",
           "make_train_step", "prefill", "remat_policy_fn",
           "resolve_device", "run_layers"]
