"""ray_tpu_torch.dag: lazy task/actor DAGs (reference: ``python/ray/dag/``).

``fn.bind(...)`` / ``Actor.bind(...)`` build a DAG of nodes without
executing; ``dag.execute(input)`` walks it, submitting tasks/creating
actors and wiring ObjectRefs between them. ``InputNode`` marks the
per-execution input. A compiled DAG (``experimental_compile``)
pre-resolves the topology so repeated executions skip graph traversal
(the reference further lowers onto mutable-plasma channels —
``compiled_dag_node.py:141``; here compilation caches the topological
schedule and reuses created actors).
"""

from ray_tpu_torch.dag.nodes import (
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "ClassMethodNode",
    "ClassNode",
    "DAGNode",
    "FunctionNode",
    "InputNode",
    "MultiOutputNode",
]
