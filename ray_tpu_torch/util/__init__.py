"""Utilities of the port: the metrics registry
(:mod:`ray_tpu_torch.util.metrics`)."""
