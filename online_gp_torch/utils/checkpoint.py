"""Checkpoints of model state trees and task wrappers (port of
``online_gp_tpu/utils/checkpoint.py``, in the same format).

Format: an ``.npz`` payload of the leaves (``leaf_0``, ``leaf_1``, ...)
and a self-describing structure JSON beside it: dict, list, tuple,
NamedTuple and None nodes encoded recursively, NamedTuple classes by
import path. Restoring needs no exemplar. A checkpoint written by the JAX
package loads here: its NamedTuple paths under ``online_gp_tpu.`` are read
as the same paths under ``online_gp_torch.`` (the string is mapped; the
JAX package is never imported), and a field the port's NamedTuple
annotates ``int`` (``num_data``, ``count``) becomes a Python int.

:func:`save_wrapper` / :func:`load_wrapper` checkpoint a task wrapper as
the JAX package does (the components of ``_WRAPPER_KEYS`` it carries),
with the stem in the JAX stems' layout, so a wrapper either package saved
loads into the other's.

The JAX package's second backend writes the leaves through
orbax-checkpoint (tensorstore, asynchronous, multi-host). Its role here is
``backend="dcp"``: the leaves go through ``torch.distributed.checkpoint``
into ``<base>.dcp/`` beside the same structure JSON. A DTensor leaf (a
row-sharded WISKI state, ``parallel/grid.py``) is written by each rank, one
shard each, and one process, or a group of another size, loads it whole.
orbax itself is not ported (it imports jax, and the card's machine has no
tensorstore): ``backend="orbax"`` and an orbax checkpoint raise
``ValueError`` naming "dcp". Checkpoints shared across the two packages
stay npz.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import typing
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_REFERENCE_PACKAGE = "online_gp_tpu."
_PACKAGE = "online_gp_torch."


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _structure_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".structure.json"


def _encode(node: Any, leaves: List[Any]) -> Dict:
    if node is None:
        return {"kind": "none"}
    if isinstance(node, dict):
        return {"kind": "dict", "items": {str(k): _encode(v, leaves) for k, v in node.items()}}
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # NamedTuple
        return {
            "kind": "namedtuple",
            "cls": f"{type(node).__module__}:{type(node).__qualname__}",
            "fields": {f: _encode(getattr(node, f), leaves) for f in node._fields},
        }
    if isinstance(node, (list, tuple)):
        return {"kind": "list" if isinstance(node, list) else "tuple", "items": [_encode(v, leaves) for v in node]}
    leaves.append(node)
    return {"kind": "leaf", "index": len(leaves) - 1}


def _port_class(path: str):
    if path.startswith(_REFERENCE_PACKAGE):
        path = _PACKAGE + path[len(_REFERENCE_PACKAGE):]
    mod, qual = path.split(":")
    cls = importlib.import_module(mod)
    for part in qual.split("."):
        cls = getattr(cls, part)
    return cls


def _decode(spec: Dict, leaves: List[Any]) -> Any:
    kind = spec["kind"]
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _decode(v, leaves) for k, v in spec["items"].items()}
    if kind == "namedtuple":
        cls = _port_class(spec["cls"])
        hints = typing.get_type_hints(cls)
        fields = {}
        for f, v in spec["fields"].items():
            val = _decode(v, leaves)
            if hints.get(f) is int and torch.is_tensor(val):
                val = int(val)
            fields[f] = val
        return cls(**fields)
    if kind == "list":
        return [_decode(v, leaves) for v in spec["items"]]
    if kind == "tuple":
        return tuple(_decode(v, leaves) for v in spec["items"])
    if kind == "leaf":
        return leaves[spec["index"]]
    raise ValueError(f"unknown checkpoint node kind {kind!r}")


def _shape(spec: Dict) -> Any:
    """The encoding without leaf indices and with the class paths mapped to
    the port's: what an exemplar must match."""
    kind = spec["kind"]
    if kind == "dict":
        return ("dict", tuple((k, _shape(v)) for k, v in spec["items"].items()))
    if kind == "namedtuple":
        cls = spec["cls"]
        if cls.startswith(_REFERENCE_PACKAGE):
            cls = _PACKAGE + cls[len(_REFERENCE_PACKAGE):]
        return ("namedtuple", cls, tuple((k, _shape(v)) for k, v in spec["fields"].items()))
    if kind in ("list", "tuple"):
        return (kind, tuple(_shape(v) for v in spec["items"]))
    return (kind,)


_NO_ORBAX = (
    "the orbax backend is not ported: orbax-checkpoint imports jax, which online_gp_torch never imports; "
    "use backend='dcp' (torch.distributed.checkpoint, sharded writes) or backend='npz'"
)


def _dcp_dir(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return os.path.abspath(base + ".dcp")


def _group_open() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def save_pytree(path: str, tree: Any, backend: str = "npz") -> None:
    """Save a tree of tensors, arrays, numbers and strings to ``path``: the
    payload plus ``.structure.json``, which records the backend.

    - "npz": an ``.npz`` payload, tensors copied to the host.
    - "dcp": the leaves through ``torch.distributed.checkpoint.save`` into
      ``<base>.dcp/`` (string leaves in the structure JSON). With a process
      group open every rank calls this: a DTensor leaf is written one shard
      a rank, and rank 0 writes the structure JSON.

    A payload of the other backend at the same path is removed, so the
    JSON's record never disagrees with the payload on disk. "orbax" (the
    JAX package's) raises ValueError naming "dcp"."""
    if backend == "orbax":
        raise ValueError(_NO_ORBAX)
    if backend not in ("npz", "dcp"):
        raise ValueError(f"unknown checkpoint backend {backend!r} (npz/dcp)")
    leaves: List[Any] = []
    encoding = _encode(tree, leaves)
    group = _group_open()
    rank0 = not group or torch.distributed.get_rank() == 0
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    record = {"treedef": None, "num_leaves": len(leaves), "encoding": encoding, "backend": backend}
    if backend == "npz":
        arrays = {
            f"leaf_{i}": leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
            for i, leaf in enumerate(leaves)
        }
        np.savez(_npz_path(path), **arrays)
        shutil.rmtree(_dcp_dir(path), ignore_errors=True)
    else:
        import torch.distributed.checkpoint as dcp

        strings, state = {}, {}
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, str):
                strings[str(i)] = leaf
            else:
                state[f"leaf_{i}"] = leaf.detach() if torch.is_tensor(leaf) else torch.as_tensor(np.asarray(leaf))
        record["strings"] = strings
        if rank0:
            shutil.rmtree(_dcp_dir(path), ignore_errors=True)
        if group:
            torch.distributed.barrier()
        dcp.save(state, checkpoint_id=_dcp_dir(path), no_dist=not group)
        if rank0 and os.path.exists(_npz_path(path)):
            os.remove(_npz_path(path))
    if rank0:
        with open(_structure_path(path), "w") as f:
            # "treedef" is the JAX package's record of its own tree type; None
            # tells its loader there is none to check against
            json.dump(record, f)
    if group and backend == "dcp":
        torch.distributed.barrier()


def _load_dcp_leaves(path: str, structure: Dict, device) -> List[Any]:
    """The leaves of a "dcp" checkpoint, each tensor whole (allocated from
    the checkpoint's metadata, whatever shards wrote it) on ``device``."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    reader = dcp.FileSystemReader(_dcp_dir(path))
    meta = reader.read_metadata().state_dict_metadata
    state = {}
    for key, m in meta.items():
        if not isinstance(m, TensorStorageMetadata):
            raise ValueError(f"{path}: leaf {key!r} of the dcp payload is not a tensor")
        state[key] = torch.empty(m.size, dtype=m.properties.dtype)
    dcp.load(state, storage_reader=reader, no_dist=not _group_open())
    strings = structure.get("strings", {})
    return [strings[str(i)] if str(i) in strings else state[f"leaf_{i}"].to(device)
            for i in range(structure["num_leaves"])]


def load_pytree(path: str, like: Optional[Any] = None, device="cuda") -> Any:
    """Load a tree saved by :func:`save_pytree` (npz or dcp) or by the JAX
    package's ``save_pytree`` (npz backend), numeric leaves as tensors on
    ``device`` (a sharded leaf whole) and string leaves as Python strings.

    With ``like`` the exemplar's structure must match the saved one, which
    raises otherwise, instead of assigning leaves by index to the wrong
    fields; the saved structure builds the tree either way.
    """
    if not os.path.exists(_structure_path(path)):
        raise ValueError(f"{path}: no self-describing structure JSON")
    with open(_structure_path(path)) as f:
        structure = json.load(f)
    backend = structure.get("backend", "npz")
    if backend == "dcp":
        leaves = _load_dcp_leaves(path, structure, device)
    elif backend == "npz":
        npz = np.load(_npz_path(path))

        def _leaf(arr):
            if arr.dtype.kind in ("U", "S"):
                return str(arr.item()) if arr.ndim == 0 else arr
            return torch.from_numpy(np.array(arr, copy=True)).to(device)

        leaves = [_leaf(npz[f"leaf_{i}"]) for i in range(len(npz.files))]
    else:
        raise ValueError(f"{path}: {backend!r} checkpoint; " + _NO_ORBAX)
    if like is not None:
        saved = _shape(structure["encoding"])
        want = _shape(_encode(like, []))
        if saved != want:
            raise ValueError(f"checkpoint structure mismatch:\n  saved:    {saved}\n  exemplar: {want}")
    return _decode(structure["encoding"], leaves)


_WRAPPER_KEYS = ("params", "stem_params", "stem_state", "state", "moments", "old")


def _stem_layers(stem) -> List[str]:
    return [name for name, _ in stem.named_children() if name.startswith("lin")]


def _stem_trees(stem):
    """The stem's weights and BatchNorm statistics in the JAX stems' layout:
    ``{"lin": {"w": (d_in, d_out), "b": (d_out,)}}`` (or ``lin0``, ``lin1``,
    ...) and ``{"bn": {"mean", "var", "momentum"}}``; ``{}`` and ``{}`` for a
    stem without parameters."""
    if not stem.has_params:
        return {}, {}
    params = {name: {"w": layer.weight.T, "b": layer.bias}
              for name, layer in stem.named_children() if name.startswith("lin")}
    bn = stem.bn
    return params, {"bn": {"mean": bn.running_mean, "var": bn.running_var, "momentum": bn.momentum}}


def save_wrapper(path: str, wrapper) -> None:
    """Checkpoint a task wrapper: its params, its stem (as ``stem_params`` and
    ``stem_state``, the JAX stems' layout), and its ``state``, ``moments``
    and ``old`` where it carries them."""
    stem_params, stem_state = _stem_trees(wrapper.stem)
    parts = dict(params=wrapper.params, stem_params=stem_params, stem_state=stem_state)
    parts.update({key: getattr(wrapper, key, None) for key in ("state", "moments", "old")})
    save_pytree(path, {key: parts[key] for key in _WRAPPER_KEYS if parts[key] is not None})


def load_wrapper(path: str, wrapper) -> None:
    """Restore a checkpoint saved by :func:`save_wrapper`, or by the JAX
    package's ``save_wrapper`` (npz), into ``wrapper`` in place, on its
    device.

    The component set comes from the saved structure, not the wrapper: a
    checkpoint saved with ``moments`` restores into a fresh wrapper whose
    ``moments`` is still None. The params become the wrapper's leaves (they
    take gradients) and its optimizers are made anew at its rate, as the
    JAX wrapper keeps the fresh optimizer state it was built with; grid
    prediction caches built on the old state are dropped.
    """
    from online_gp_torch.convert import stem_from_numpy
    from online_gp_torch.utils.optim import tree_leaves

    restored = load_pytree(path, device=wrapper.device)
    stem_params = restored.pop("stem_params", None)
    stem_state = restored.pop("stem_state", None)
    if wrapper.stem.has_params and stem_params:
        stem_from_numpy(wrapper.stem, _numpy_tree(stem_params), _numpy_tree(stem_state or {}), wrapper.device)
    for key, value in restored.items():
        setattr(wrapper, key, value)
    if "params" in restored:
        for leaf in tree_leaves(wrapper.params):
            leaf.requires_grad_(True)
        wrapper.set_lr(wrapper.lr)
    if getattr(wrapper, "_pred_caches", None) is not None:
        wrapper._pred_caches = None


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.cpu().numpy() for k, v in tree.items()}
