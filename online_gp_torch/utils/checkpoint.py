"""Checkpoints of model state trees (port of the ``.npz`` part of
``online_gp_tpu/utils/checkpoint.py``, in the same format).

Format: an ``.npz`` payload of the leaves (``leaf_0``, ``leaf_1``, ...)
and a self-describing structure JSON beside it: dict, list, tuple,
NamedTuple and None nodes encoded recursively, NamedTuple classes by
import path. Restoring needs no exemplar. A checkpoint written by the JAX
package loads here: its NamedTuple paths under ``online_gp_tpu.`` are read
as the same paths under ``online_gp_torch.`` (the string is mapped; the
JAX package is never imported), and a field the port's NamedTuple
annotates ``int`` (``num_data``, ``count``) becomes a Python int.

Left for the port of the experiment layer (ROADMAP Queue 1 item 9): the
orbax backend and ``save_wrapper`` / ``load_wrapper``.
"""

from __future__ import annotations

import importlib
import json
import os
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


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors, arrays, numbers and strings to ``path``
    (``.npz`` payload plus ``.structure.json``). Tensors are copied to the
    host."""
    leaves: List[Any] = []
    encoding = _encode(tree, leaves)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {
        f"leaf_{i}": leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
        for i, leaf in enumerate(leaves)
    }
    np.savez(_npz_path(path), **arrays)
    with open(_structure_path(path), "w") as f:
        # "treedef" is the JAX package's record of its own tree type; None
        # tells its loader there is none to check against
        json.dump({"treedef": None, "num_leaves": len(leaves), "encoding": encoding, "backend": "npz"}, f)


def load_pytree(path: str, like: Optional[Any] = None, device="cuda") -> Any:
    """Load a tree saved by :func:`save_pytree` or by the JAX package's
    ``save_pytree`` (npz backend), numeric leaves as tensors on ``device``
    and string leaves as Python strings.

    With ``like`` the exemplar's structure must match the saved one, which
    raises otherwise, instead of assigning leaves by index to the wrong
    fields; the saved structure builds the tree either way.
    """
    if not os.path.exists(_structure_path(path)):
        raise ValueError(f"{path}: no self-describing structure JSON")
    with open(_structure_path(path)) as f:
        structure = json.load(f)
    if structure.get("backend", "npz") != "npz":
        raise NotImplementedError(
            f"{path}: the {structure['backend']!r} backend waits for the port of the experiment layer "
            "(ROADMAP Queue 1 item 9); the port reads npz checkpoints"
        )
    npz = np.load(_npz_path(path))

    def _leaf(arr):
        if arr.dtype.kind in ("U", "S"):
            return str(arr.item()) if arr.ndim == 0 else arr
        return torch.from_numpy(np.array(arr, copy=True)).to(device)

    leaves = [_leaf(npz[f"leaf_{i}"]) for i in range(len(npz.files))]
    if like is not None:
        saved = _shape(structure["encoding"])
        want = _shape(_encode(like, []))
        if saved != want:
            raise ValueError(f"checkpoint structure mismatch:\n  saved:    {saved}\n  exemplar: {want}")
    return _decode(structure["encoding"], leaves)
