"""Runtime pieces of the port. So far only the serving metric catalog
(:mod:`ray_tpu_torch.core.metric_defs`); the controller, scheduler and
object store are still to be ported."""
