"""Parameter trees in the JAX package's layout.

The JAX package keeps a model's parameters as nested dicts with each
layer leaf stacked (L, ...); the port keeps a :class:`DecoderLM` with one
module a layer.  These helpers walk a tree of dicts, named tuples
(``OptState``), lists, tuples, ``DecoderLM``s and tensors in the JAX
package's leaf order (dict keys sorted, named-tuple fields in order) and
name each leaf as the JAX package's ``_leaf_path`` names it, with ``__``
between keys: a ``DecoderLM``'s layer leaf ``wq`` of layer ``i`` is
element ``i`` of the stacked leaf ``layers__wq``.  ``None`` holds no
leaf, as in a JAX pytree.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, NamedTuple, Optional, \
    Tuple

from torch import nn

from .transformer import CrossLayer, DecoderLayer, DecoderLM

__all__ = ["Leaf", "leaves", "rebuild", "tree_map"]


class Leaf(NamedTuple):
    """One tensor of a tree: its path of keys, its layer index when it is
    one layer of a stacked leaf (else None), and the tensor."""
    path: Tuple[str, ...]
    index: Optional[int]
    value: Any

    @property
    def name(self) -> str:
        """The JAX package's file name of the (stacked) leaf."""
        return "__".join(self.path) or "leaf"

    @property
    def stacked_ndim(self) -> int:
        """Rank of the leaf as the JAX package holds it (layers stacked)."""
        return self.value.ndim + (self.index is not None)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _lm_groups(lm: DecoderLM):
    """(key, value) of a ``DecoderLM``'s JAX tree in sorted key order: a
    tensor, or a list of per-layer modules for a stacked group."""
    groups = {"embed": lm.embed, "final_norm": lm.final_norm,
              "layers": list(lm.layers)}
    if len(lm.cross_layers):
        groups["cross_layers"] = list(lm.cross_layers)
    if lm.lm_head is not None:
        groups["lm_head"] = lm.lm_head
    return sorted(groups.items())


def _walk(tree, path: Tuple[str, ...], out: List[Leaf]) -> None:
    if tree is None:
        return
    if isinstance(tree, DecoderLM):
        for key, val in _lm_groups(tree):
            if isinstance(val, list):
                for name in sorted(val[0].keys()):
                    for i, lp in enumerate(val):
                        out.append(Leaf(path + (key, name), i, lp[name]))
            else:
                out.append(Leaf(path + (key,), None, val))
    elif isinstance(tree, dict):
        for key in sorted(tree):
            _walk(tree[key], path + (str(key),), out)
    elif _is_namedtuple(tree):
        for name, val in zip(tree._fields, tree):
            _walk(val, path + (name,), out)
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            _walk(val, path + (str(i),), out)
    else:
        out.append(Leaf(path, None, tree))


def leaves(tree) -> List[Leaf]:
    """Every tensor of ``tree`` in the JAX package's leaf order; a stacked
    leaf's layers come one after another."""
    out: List[Leaf] = []
    _walk(tree, (), out)
    return out


def _param(t) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=t.requires_grad)


def _rebuild(like, it: Iterator):
    if like is None:
        return None
    if isinstance(like, DecoderLM):
        got = {}
        for key, val in _lm_groups(like):
            if isinstance(val, list):
                mods = [{} for _ in val]
                for name in sorted(val[0].keys()):
                    for i in range(len(val)):
                        mods[i][name] = _param(next(it))
                cls = DecoderLayer if key == "layers" else CrossLayer
                got[key] = [cls(dict(sorted(m.items()))) for m in mods]
            else:
                got[key] = next(it)
        return DecoderLM(_param(got["embed"]), _param(got["final_norm"]),
                         got["layers"], got.get("cross_layers", ()),
                         _param(got["lm_head"]) if "lm_head" in got
                         else None)
    if isinstance(like, dict):
        vals = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*[_rebuild(v, it) for v in like])
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    return next(it)


def rebuild(like, values) -> Any:
    """A tree of ``like``'s structure holding ``values`` in the order of
    :func:`leaves`.  A ``DecoderLM``'s tensors become Parameters that
    require a gradient when the value does."""
    it = iter(values)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable[..., Any], tree, *rest) -> Any:
    """``fn(leaf, *the same leaf of each of rest)`` over ``tree``'s
    leaves (the trees of ``rest`` share its structure)."""
    flat = [leaves(t) for t in (tree,) + rest]
    return rebuild(tree, [fn(*(f[i].value for f in flat))
                          for i in range(len(flat[0]))])
