"""The FX-graph toolbox of the contract analyzer (counterpart of
``repro.analysis.jaxpr_tools``).

The analyzer's input is the FX graph (``make_fx``) of ONE solver step:
a flat list of nodes, no nested bodies, so the JAX package's
``subjaxprs`` / ``find_while_body`` have no counterpart here.

Unlike a jaxpr, the graph is not functional.  An in-place op writes a
tensor another node made, and a later reader may point at the node that
made the buffer, not at the write: ``c10d.recv_`` returns only a
``Work``, so the read of a received halo plane points at the
``zeros_like`` that allocated it.  A walk over node arguments alone
loses every edge through such a write.  :func:`transitive_inputs` is
therefore mutation-aware: a node that writes an argument (its schema
says ``alias_info.is_write``, or it is an in-place collective of
``c10d``, whose schemas carry no alias annotations) counts as a producer
of that tensor, and of every view of it, for each later reader.
"""
from __future__ import annotations

import operator
from typing import Dict, Iterable, List, Set

from torch import fx

__all__ = ["op_name", "count_op", "find_op_nodes", "written_args",
           "transitive_inputs"]


def op_name(node: fx.Node) -> str:
    """``"namespace::name"`` of a node's op (``"aten::mul"``,
    ``"repro_torch::fused_dots"``, ``"c10d::allreduce_"``); ``""`` for
    placeholders, attributes, outputs and plain Python calls."""
    if node.op != "call_function":
        return ""
    schema = getattr(node.target, "_schema", None)
    return "" if schema is None else schema.name


def _graph(g) -> fx.Graph:
    return g.graph if isinstance(g, fx.GraphModule) else g


def find_op_nodes(graph, name: str) -> List[fx.Node]:
    """Every node of the op ``name`` (``"namespace::name"``), in order."""
    return [n for n in _graph(graph).nodes if op_name(n) == name]


def count_op(graph, name: str) -> int:
    """Occurrences of the op ``name`` in the graph."""
    return len(find_op_nodes(graph, name))


def _tensor_args(value) -> List[fx.Node]:
    """The nodes in an argument (a node, or a list of them)."""
    if isinstance(value, fx.Node):
        return [value]
    if isinstance(value, (list, tuple)):
        return [v for v in value if isinstance(v, fx.Node)]
    return []


def _bound_args(node: fx.Node, schema) -> List:
    """The node's arguments in the schema's order (positional, then by
    keyword; missing ones ``None``)."""
    out = list(node.args) + [None] * (len(schema.arguments) - len(node.args))
    for i, arg in enumerate(schema.arguments):
        if i >= len(node.args) and arg.name in node.kwargs:
            out[i] = node.kwargs[arg.name]
    return out


def _inplace_collective(schema) -> bool:
    """An in-place ``c10d`` op (``recv_``, ``allreduce_``, ...): it writes
    its first argument, though its schema does not say so."""
    ns, _, name = schema.name.partition("::")
    return ns == "c10d" and name.endswith("_")


def written_args(node: fx.Node) -> List[fx.Node]:
    """The nodes whose tensors ``node`` writes in place."""
    schema = getattr(node.target, "_schema", None)
    if node.op != "call_function" or schema is None:
        return []
    args = _bound_args(node, schema)
    out = []
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is not None and arg.alias_info.is_write:
            out += _tensor_args(args[i])
    if not out and _inplace_collective(schema) and args:
        out = _tensor_args(args[0])
    return out


class _Aliases:
    """Union-find of the nodes whose outputs share memory: a view and its
    base, an in-place op's result and the tensor it wrote, a ``getitem``
    and the container it indexes."""

    def __init__(self, nodes: Iterable[fx.Node]):
        self.parent: Dict[fx.Node, fx.Node] = {}
        for n in nodes:
            for other in self._aliased(n):
                self.union(n, other)

    def find(self, n: fx.Node) -> fx.Node:
        root = n
        while self.parent.get(root, root) is not root:
            root = self.parent[root]
        while n is not root:
            self.parent[n], n = root, self.parent.get(n, n)
        return root

    def union(self, a: fx.Node, b: fx.Node) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra is not rb:
            self.parent[ra] = rb

    @staticmethod
    def _aliased(n: fx.Node) -> List[fx.Node]:
        if n.op != "call_function":
            return []
        if n.target is operator.getitem:
            return _tensor_args(n.args[0])
        schema = getattr(n.target, "_schema", None)
        if schema is None:
            return []
        args = _bound_args(n, schema)
        sets = set()
        for ret in schema.returns:
            if ret.alias_info is not None:
                sets |= set(ret.alias_info.before_set)
        out = []
        for i, arg in enumerate(schema.arguments):
            info = arg.alias_info
            if info is not None and sets & set(info.before_set):
                out += _tensor_args(args[i])
        if _inplace_collective(schema) and args:
            out += _tensor_args(args[0])
        return out


def transitive_inputs(graph, target: fx.Node) -> Set[fx.Node]:
    """Every node ``target`` transitively consumes, through its arguments
    and through the in-place writes to them.

    A node reading a tensor depends on the node that made it and on every
    write to it (or to a view sharing its memory) earlier in the graph; a
    write depends on what it reads in turn.  Ops are atomic: a needed
    output pulls in all of its node's inputs, so the walk can only report
    MORE dependencies, never hide a real edge."""
    nodes = list(_graph(graph).nodes)
    order = {n: i for i, n in enumerate(nodes)}
    aliases = _Aliases(nodes)
    writes: Dict[fx.Node, List[fx.Node]] = {}
    for n in nodes:
        for w in written_args(n):
            writes.setdefault(aliases.find(w), []).append(n)

    needed: Set[fx.Node] = set()
    stack = [target]
    while stack:
        node = stack.pop()
        for arg in node.all_input_nodes:
            for p in [arg] + [w for w in writes.get(aliases.find(arg), ())
                              if order[w] < order[node]]:
                if p not in needed:
                    needed.add(p)
                    stack.append(p)
    return needed

