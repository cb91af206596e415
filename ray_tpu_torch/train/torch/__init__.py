from ray_tpu_torch.train.torch.config import TorchConfig
from ray_tpu_torch.train.torch.torch_trainer import TorchTrainer

__all__ = ["TorchConfig", "TorchTrainer"]
