"""Parallelism helpers of the port. So far only the int8 blockwise wire
format (:mod:`ray_tpu_torch.parallel.quantization`) that the KV hand-off
ships; meshes, sharding and collectives are still to be ported."""
