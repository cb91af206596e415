"""Error types the port raises. The port keeps its own copies: it
imports nothing from the JAX package."""


class RayTpuTorchError(Exception):
    """Base class for the port's errors."""


class EngineDeadError(RayTpuTorchError):
    """The engine's step loop died; every queued or in-flight request is
    failed with this, so consumers never hang on a dead engine."""


class RequestTooLargeError(RayTpuTorchError):
    """prompt_len + 1 exceeds the engine's per-request window
    (``max_seq_len``): the request can never be admitted."""
