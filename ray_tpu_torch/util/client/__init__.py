"""Ray Client equivalent: drive a remote cluster from a process that is
not part of it (reference: ``python/ray/util/client/worker.py:81`` —
``ray.init("ray://host:port")`` proxies the public API over gRPC to a
server hosting a real driver). Here the wire is ZMQ over TCP with
pickled frames; the server process is a normal cluster driver that
executes API calls on each client's behalf and leases object/actor
references to the connection.
"""

from ray_tpu_torch.util.client.server import ClientServer
from ray_tpu_torch.util.client.worker import ClientWorker, connect

__all__ = ["ClientServer", "ClientWorker", "connect"]
