"""Experimental: mutable-object channels + compiled-DAG fast path.

Reference: ``python/ray/experimental/channel.py`` and
``src/ray/core_worker/experimental_mutable_object_manager.h``.
"""

from ray_tpu_torch.experimental.channel import Channel, ChannelClosed, ReaderHandle

__all__ = ["Channel", "ChannelClosed", "ReaderHandle"]
