"""DAG node types + execution.

Reference: ``python/ray/dag/dag_node.py:25`` (DAGNode),
``function_node.py``, ``class_node.py``, ``input_node.py``,
``output_node.py``, and the compiled path ``compiled_dag_node.py:141``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch


class DAGNode:
    """Base: a lazily-bound computation with upstream deps."""

    def __init__(self, args: Tuple = (), kwargs: Optional[Dict] = None):
        self._bound_args = args
        self._bound_kwargs = kwargs or {}

    # -- traversal ----------------------------------------------------
    def _deps(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def _apply(self, ctx: "_ExecutionContext"):
        raise NotImplementedError

    # -- public -------------------------------------------------------
    def execute(self, *input_args, **input_kwargs):
        """Execute the DAG rooted at this node; returns ObjectRef(s)
        (reference ``DAGNode.execute``)."""
        ctx = _ExecutionContext(input_args, input_kwargs)
        return _resolve(self, ctx)

    def experimental_compile(self) -> "CompiledDAG":
        return CompiledDAG(self)


class _ExecutionContext:
    def __init__(self, input_args, input_kwargs):
        self.input_args = input_args
        self.input_kwargs = input_kwargs
        self.cache: Dict[int, Any] = {}
        self.actors: Dict[int, Any] = {}


def _resolve(node, ctx: "_ExecutionContext"):
    if not isinstance(node, DAGNode):
        return node
    key = id(node)
    if key not in ctx.cache:
        ctx.cache[key] = node._apply(ctx)
    return ctx.cache[key]


def _resolve_args(node: DAGNode, ctx) -> Tuple[Tuple, Dict]:
    args = tuple(_resolve(a, ctx) for a in node._bound_args)
    kwargs = {k: _resolve(v, ctx) for k, v in node._bound_kwargs.items()}
    return args, kwargs


class InputNode(DAGNode):
    """Per-execution input placeholder (reference ``input_node.py``).
    Supports context-manager authoring style::

        with InputNode() as inp:
            dag = f.bind(inp)
    """

    def __init__(self):
        super().__init__()

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc):
        return False

    def __getattr__(self, key: str) -> "InputAttributeNode":
        if key.startswith("_"):
            raise AttributeError(key)
        return InputAttributeNode(self, key)

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key)

    def _apply(self, ctx):
        if len(ctx.input_args) == 1 and not ctx.input_kwargs:
            return ctx.input_args[0]
        if not ctx.input_args and ctx.input_kwargs:
            return ctx.input_kwargs
        return ctx.input_args


class InputAttributeNode(DAGNode):
    def __init__(self, parent: InputNode, key):
        super().__init__((parent,))
        self._key = key

    def _apply(self, ctx):
        if isinstance(self._key, str) and ctx.input_kwargs and \
                self._key in ctx.input_kwargs:
            return ctx.input_kwargs[self._key]
        if isinstance(self._key, int):
            return ctx.input_args[self._key]
        value = _resolve(self._bound_args[0], ctx)
        if isinstance(value, dict):
            return value[self._key]
        return getattr(value, self._key)


class FunctionNode(DAGNode):
    """``remote_fn.bind(...)`` (reference ``function_node.py``)."""

    def __init__(self, remote_function, args, kwargs):
        super().__init__(args, kwargs)
        self._fn = remote_function

    def _apply(self, ctx):
        args, kwargs = _resolve_args(self, ctx)
        return self._fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """``ActorClass.bind(...)``: an actor created at execute time and
    cached per execution context (reference ``class_node.py``)."""

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls

    def _apply(self, ctx):
        key = id(self)
        if key not in ctx.actors:
            args, kwargs = _resolve_args(self, ctx)
            ctx.actors[key] = self._actor_cls.remote(*args, **kwargs)
        return ctx.actors[key]

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodBinder(self, name)


class _ClassMethodBinder:
    def __init__(self, class_node: ClassNode, method: str):
        self._class_node = class_node
        self._method = method

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method: str, args, kwargs):
        super().__init__((class_node,) + args, kwargs)
        self._method = method

    def _apply(self, ctx):
        actor = _resolve(self._bound_args[0], ctx)
        args = tuple(_resolve(a, ctx) for a in self._bound_args[1:])
        kwargs = {k: _resolve(v, ctx)
                  for k, v in self._bound_kwargs.items()}
        return getattr(actor, self._method).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Bundle several leaves (reference ``output_node.py``)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs))

    def _apply(self, ctx):
        return [_resolve(a, ctx) for a in self._bound_args]


def _channel_stage_loop(instance, in_reader, out_chan, method):
    """Runs ON the stage actor for the pipeline's lifetime: read from the
    upstream channel, execute the bound method, write downstream — zero
    control-plane messages per item (reference: compiled-DAG actors block
    on mutable-object channels, experimental_mutable_object_manager.h).

    Items travel as ("ok", value) / ("err", exception) envelopes: a stage
    exception flows down the chain to the driver's get() instead of
    silently wedging the pipeline; the stage keeps serving later items."""
    from ray_tpu_torch.experimental.channel import ChannelClosed
    fn = getattr(instance, method)
    try:
        while True:
            try:
                tag, value = in_reader.read()
            except ChannelClosed:
                out_chan.close()
                return "closed"
            if tag == "ok":
                try:
                    out_chan.write(("ok", fn(value)))
                    continue
                except ValueError:
                    raise  # oversized result: a channel-config error
                except BaseException as e:  # noqa: BLE001
                    out_chan.write(("err", e))
                    continue
            out_chan.write((tag, value))  # pass an upstream error along
    finally:
        in_reader.close()


class CompiledDAGRef:
    """Result handle of a channel-pipeline execute (reference:
    ``CompiledDAGRef`` — resolved via ``ray.get``)."""

    def __init__(self, pipeline: "_ChannelPipeline", seq: int):
        self._pipeline = pipeline
        self._seq = seq

    def __dag_local_value__(self, timeout: Optional[float] = None):
        return self._pipeline._value_for(self._seq, timeout)

    def get(self, timeout: Optional[float] = None):
        return self.__dag_local_value__(timeout)


class _ChannelPipeline:
    """Linear actor chain wired with mutable shm channels: one write at
    the head, one read at the tail, per execution — stages stream through
    shared memory with no per-hop RPC or object-store traffic."""

    def __init__(self, actors: List[Any], methods: List[str],
                 capacity: int):
        from ray_tpu_torch.experimental.channel import Channel
        self.chans = [Channel(capacity) for _ in range(len(actors) + 1)]
        self._loops = []
        for i, (actor, method) in enumerate(zip(actors, methods)):
            self._loops.append(actor.__ray_call__.remote(
                _channel_stage_loop, self.chans[i].reader(0),
                self.chans[i + 1], method))
        self._out = self.chans[-1].reader(0)
        self._next_submit = 0
        self._next_read = 0
        self._done: Dict[int, Any] = {}

    #: results buffered for out-of-order gets; dropped refs must not
    #: accumulate forever
    _MAX_BUFFERED = 4096

    def execute(self, value, timeout: Optional[float] = None
                ) -> CompiledDAGRef:
        seq = self._next_submit
        self._next_submit += 1
        self.chans[0].write(("ok", value), timeout)
        return CompiledDAGRef(self, seq)

    def _value_for(self, seq: int, timeout: Optional[float]):
        while seq not in self._done:
            if self._next_read > seq:
                raise RuntimeError("compiled DAG result already consumed "
                                   "or evicted")
            tag, value = self._out.read(timeout)
            self._done[self._next_read] = (tag, value)
            self._next_read += 1
            if len(self._done) > self._MAX_BUFFERED:
                self._done.pop(min(self._done))  # oldest dropped ref
        tag, value = self._done.pop(seq)
        if tag == "err":
            raise value
        return value

    def teardown(self) -> None:
        try:
            self.chans[0].close()
        except TimeoutError:
            pass  # a wedged stage: actors are killed by CompiledDAG
        try:
            ray_tpu_torch.get(self._loops, timeout=10)
        except Exception:
            pass
        self._out.close()
        for ch in self.chans:
            ch.destroy()


class CompiledDAG:
    """Repeat-execution form (reference ``compiled_dag_node.py:141``).
    A linear chain of bound actor methods over one input compiles to a
    mutable-channel pipeline: every hop moves through shared memory with
    zero per-call control-plane messages. Other shapes keep the
    persistent-actor fast path (actors created once, RPC per hop)."""

    #: per-value channel capacity for compiled pipelines
    channel_capacity: int = 1 << 20

    def __init__(self, root: DAGNode):
        self._root = root
        self._lock = threading.Lock()
        self._persistent_actors: Dict[int, Any] = {}
        self._pipeline: Optional[_ChannelPipeline] = None
        self._pipeline_checked = False

    def _try_build_pipeline(self) -> Optional[_ChannelPipeline]:
        """Detect InputNode -> m1 -> m2 -> ... (each stage a single-arg
        bound actor method whose data dependency is the previous stage)."""
        chain: List[ClassMethodNode] = []
        node = self._root
        while isinstance(node, ClassMethodNode):
            if node._bound_kwargs or len(node._bound_args) != 2:
                return None
            if not isinstance(node._bound_args[0], ClassNode):
                return None
            chain.append(node)
            node = node._bound_args[1]
        if not isinstance(node, InputNode) or not chain:
            return None
        # each stage needs its own actor: two loops on one serial actor
        # would deadlock (the second never starts)
        class_nodes = [id(n._bound_args[0]) for n in chain]
        if len(set(class_nodes)) != len(class_nodes):
            return None
        chain.reverse()
        ctx = _ExecutionContext((), {})
        ctx.actors = self._persistent_actors
        actors = [n._bound_args[0]._apply(ctx) for n in chain]
        methods = [n._method for n in chain]
        return _ChannelPipeline(actors, methods, self.channel_capacity)

    def execute(self, *args, **kwargs):
        with self._lock:
            if not self._pipeline_checked:
                self._pipeline_checked = True
                try:
                    self._pipeline = self._try_build_pipeline()
                except Exception:
                    self._pipeline = None
            if self._pipeline is not None:
                if len(args) != 1 or kwargs:
                    # the stage actors are now dedicated to their channel
                    # loops — an RPC fallback would queue behind them
                    # forever, so refuse loudly instead
                    raise TypeError(
                        "a compiled channel pipeline takes exactly one "
                        "positional input")
                return self._pipeline.execute(args[0])
            ctx = _ExecutionContext(args, kwargs)
            ctx.actors = self._persistent_actors
            out = _resolve(self._root, ctx)
        if isinstance(out, list):
            return out
        return out

    def teardown(self) -> None:
        with self._lock:
            if self._pipeline is not None:
                self._pipeline.teardown()
                self._pipeline = None
            for actor in self._persistent_actors.values():
                try:
                    ray_tpu_torch.kill(actor)
                except Exception:
                    pass
            self._persistent_actors.clear()
