"""The core runtime of the port: ids, config, the wire protocol,
serialization (torch tensors out of band), the shared-memory object
store, the reference counter, the scheduler, controller, node manager,
zygote and workers (copies of ``ray_tpu/core/``)."""
