"""Logical-axis sharding rules: the JAX package's rule table, resolved to
per-rank slices instead of GSPMD shardings.

Model code describes every parameter leaf by *logical* axis names
(``("attn_row", "heads")``); a rule table maps logical names to mesh
axes.  Under JAX a ``NamedSharding`` per leaf lets GSPMD place the data;
here each rank holds its slice of every leaf (``shard_of``) and the train
step issues the collectives itself (``training/train_step.py``), so one
rule table still decides the whole layout.

Default rule table (the JAX package's, entry for entry):
    batch   -> (pod, data)      DP across pods and the data axis
    seq     -> model            sequence/context parallelism
    ff      -> model            the MLP hidden
    expert  -> model            EP when num_experts % model == 0
    vocab   -> model
    kv_seq  -> model            decode: KV cache sharded along cache seq
    channels-> model            SSM channel sharding (mamba/mLSTM dv)
    heads   -> None             (context-parallel attention: heads local)
    attn_row-> model            QKV/O weight input dim

A spec is a tuple with one entry per leading dimension (trailing
replicated dimensions dropped, as ``PartitionSpec`` prints them): a mesh
axis name, a tuple of names, or None.  A mesh is anything with
``axis_names`` and a ``shape`` mapping each name to its size
(``launch/mesh.Mesh``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence

import torch


class AxisRules(dict):
    """Mapping from logical axis name -> mesh axis (str, tuple, or None)."""


def default_rules(multi_pod: bool = False) -> AxisRules:
    dp = ("pod", "data") if multi_pod else ("data",)
    return AxisRules({
        "batch": dp,
        "seq": "model",
        "ff": "model",
        "expert": "model",
        "vocab": "model",
        "kv_seq": "model",
        "channels": "model",
        "heads": None,
        "attn_row": "model",   # QKV/O weight input dim (row-parallel)
        "d_model": None,
        "stage": "pod",
        # paged tensor-parallel serving (sharding/tp.py): KV page pools
        # (Hkv, P, page_size, D) shard kv heads over the head-group axis
        # and within-page rows over the page-row axis
        "kv_heads": "model",
        "page_row": "tp_seq",
    })


_RULES: contextvars.ContextVar = contextvars.ContextVar(
    "axis_rules", default=None)
_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "axis_mesh", default=None)


@contextlib.contextmanager
def axis_rules(rules: Optional[AxisRules] = None, mesh=None):
    """Activate a rule table (and optionally a mesh) for model code.
    Under a mesh with a model axis the model runs this rank's share
    (``models/lm.py``); the train step enters it
    (``training/train_step.py``)."""
    if rules is None and mesh is not None:
        rules = default_rules(multi_pod="pod" in mesh.axis_names)
    t1 = _RULES.set(rules)
    t2 = _MESH.set(mesh)
    try:
        yield rules
    finally:
        _RULES.reset(t1)
        _MESH.reset(t2)


def current_rules() -> Optional[AxisRules]:
    return _RULES.get()


def current_mesh():
    return _MESH.get()


def logical_to_spec(logical: Sequence[Optional[str]],
                    rules: Optional[AxisRules] = None, mesh=None) -> tuple:
    """Translate logical axis names to a spec under the rules.

    Drops mesh axes that do not exist (e.g. 'pod' on a single-pod mesh)
    and axes already used by an earlier dimension (a tensor can map each
    mesh axis only once; first occurrence wins, e.g. seq beats ff for
    activations).  Divisibility is the caller's (``param_sharding_tree``
    sees the shape)."""
    rules = rules or current_rules() or AxisRules()
    mesh = mesh or current_mesh()
    axes = []
    used: set = set()
    for name in logical:
        ax = rules.get(name) if name else None
        if ax is None:
            axes.append(None)
            continue
        if isinstance(ax, str):
            ax = (ax,)
        ax = tuple(a for a in ax
                   if (mesh is None or a in mesh.axis_names)
                   and a not in used)
        used.update(ax)
        axes.append(ax if len(ax) > 1 else (ax[0] if ax else None))
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


def entry_axes(entry) -> tuple:
    """A spec entry as a tuple of mesh axis names (() for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _divides(array_dim: int, mesh, axis) -> bool:
    if axis is None or mesh is None:
        return True
    size = 1
    for a in entry_axes(axis):
        size *= mesh.shape[a]
    return array_dim % size == 0


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The identity.  Under JAX it pins an activation's layout for GSPMD;
    here no compiler places data: the train step makes the layout
    explicit (each rank holds its rows of the batch and the sequence,
    ``models/lm.py`` gathers what a rank needs whole), so there is
    nothing to constrain."""
    return x


# ---------------------------------------------------------------------------
# Parameter shardings
# ---------------------------------------------------------------------------

def is_logical_leaf(x) -> bool:
    """True for an (axes, shape) logical annotation.

    Strict: axes entries must be str / None / tuple-of-str and shape
    entries int / None.  (Loose checks mistake 2-field NamedTuples like
    KVCache for leaves and replicate everything under them.)
    """
    if not (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], tuple) and isinstance(x[1], tuple)):
        return False
    axes, shape = x
    for a in axes:
        if a is None or isinstance(a, str):
            continue
        if isinstance(a, tuple) and a and all(isinstance(b, str) for b in a):
            continue
        return False
    return all(d is None or isinstance(d, int) for d in shape)


def is_spec(x) -> bool:
    """A spec leaf: a plain tuple (NamedTuples are tree nodes)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def map_tree(fn: Callable, tree, is_leaf: Callable):
    """``fn`` over the leaves of a tree of dicts, lists and NamedTuples
    whose leaves ``is_leaf`` names (tuples are leaves here, not nodes)."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, is_leaf) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v, is_leaf) for v in tree))
    raise TypeError(f"not a tree node or leaf: {type(tree).__name__}")


def flatten(tree, is_leaf: Callable) -> list:
    """The leaves in the port's tree order (``training/tree.py``: dict
    keys sorted, lists and NamedTuples in order)."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k], is_leaf)]
    return [x for v in tree for x in flatten(v, is_leaf)]


def param_sharding_tree(param_logical_tree, mesh,
                        rules: Optional[AxisRules] = None):
    """Map a tree of logical-axis leaves to spec tuples (``is_spec``
    leaves): ``logical_to_spec``, with every axis whose size does not
    divide its dimension dropped to None (that dimension stays whole)."""
    rules = rules or default_rules(multi_pod="pod" in mesh.axis_names)

    def to_spec(logical_and_shape):
        logical, shape = logical_and_shape
        spec = logical_to_spec(logical, rules, mesh)
        return tuple(ax if _divides(shape[i], mesh, ax) else None
                     for i, ax in enumerate(spec))

    return map_tree(to_spec, param_logical_tree, is_logical_leaf)


def spec_axes(spec: tuple) -> tuple:
    """Every mesh axis a spec shards over, in order."""
    return tuple(a for entry in spec for a in entry_axes(entry))


def shard_index(entry, mesh, coords: dict) -> tuple:
    """(index, count) of a rank's piece along a dimension whose spec entry
    is ``entry``: the axes' coordinates read row-major, first axis major
    (the device order of a JAX ``NamedSharding``)."""
    idx, n = 0, 1
    for a in entry_axes(entry):
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return idx, n


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The shape of this rank's piece of a leaf of ``shape`` under
    ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        out[dim] //= shard_index(entry, mesh, mesh.coords)[1]
    return tuple(out)


def shard_of(tensor: torch.Tensor, spec: tuple, mesh,
             coords: Optional[dict] = None) -> torch.Tensor:
    """The piece of ``tensor`` that the rank at ``coords`` (axis name ->
    coordinate; default the mesh's own rank) holds under ``spec``: a
    contiguous copy where ``spec`` shards, ``tensor`` itself where it
    replicates."""
    coords = mesh.coords if coords is None else coords
    out = tensor
    for dim, entry in enumerate(spec):
        idx, n = shard_index(entry, mesh, coords)
        if n > 1:
            size = out.shape[dim] // n
            out = out.narrow(dim, idx * size, size)
    return out if out is tensor else out.contiguous()
