"""Checkpoint and resume: the port's long-lived objects as ``.npz`` files.

Port of ``cpkrylov_tpu/utils/checkpoint.py``.  A built preconditioner (the
expensive host LDL^T and its packing) or a solve's output is a tree of
frozen dataclasses, NamedTuples and tuples whose leaves are tensors, so a
checkpoint is one array per leaf plus a structure signature: a JSON string,
stored as a uint8 array, that names every node's class, holds the option
dataclasses' fields, strings and Nones, and each leaf's dtype and shape.
Nothing is pickled; ``np.load(..., allow_pickle=False)`` reads the file.

Every tensor, numpy array and Python or numpy scalar (a size, a panel, an
iteration count, a measured time) is data: a leaf of the file.  Two
factors of one system built with other options or panels differ in the
signature (the options, the leaves' shapes); two outputs of one solve do
not, and load into each other.

``load_pytree(None, path)`` rebuilds the object from the file alone: the
classes are imported by the names the signature gives (only from this
package), frozen dataclasses are constructed anew, and the tensors go to
``device`` (the card unless the caller asks for the CPU).  So a saved
preconditioner is reloaded in a new process without its LDL^T or packing.
``load_pytree(template, path)`` does the same after checking that the
template has the stored signature (ValueError "checkpoint structure
mismatch" when not), and puts each tensor on the device of the template's
tensor in its place.  A ``FunctionOperator`` holds a callable, which a file
cannot: it is recorded by class, and only a template can supply it.
Per-device kernel state (the bidiagonal scan's ticket buffer) lives in its
wrapper module, not in the factor, so nothing of it is stored; a loaded
factor gets that state on its first launch, as a new one does.
"""
from __future__ import annotations

import dataclasses
import importlib
import json

import numpy as np
import torch

from ..config import PrecondOptions, SolverOptions
from ..operators.linop import FunctionOperator
from .device import resolve_device

SIGNATURE_KEY = "__signature__"
_PACKAGE = __name__.split(".")[0]
_SCALARS = {"bool": bool, "int": int, "float": float}


def _cls_name(obj) -> str:
    return f"{type(obj).__module__}.{type(obj).__qualname__}"


def _cls(name: str):
    """The class ``_cls_name`` named: a module-level dataclass or
    NamedTuple of this package (a file names nothing else)."""
    module, _, qual = name.rpartition(".")
    if module.split(".")[0] != _PACKAGE:
        raise ValueError(f"checkpoint names a class outside {_PACKAGE}: "
                         f"{name}")
    cls = getattr(importlib.import_module(module), qual, None)
    if not (dataclasses.is_dataclass(cls) or hasattr(cls, "_fields")):
        raise ValueError(f"checkpoint names {name}, not a dataclass")
    return cls


def _flatten(obj, leaves: list | None):
    """Signature node of ``obj``; appends its leaves as numpy arrays to
    ``leaves`` unless that is None (the signature alone: no copies)."""
    def leaf(arr):
        if leaves is not None:
            leaves.append(arr)

    if isinstance(obj, torch.Tensor):
        if leaves is not None:
            leaves.append(obj.detach().cpu().numpy())
        dt = torch.empty(0, dtype=obj.dtype).numpy().dtype
        return {"tensor": [dt.str, list(obj.shape)]}
    if isinstance(obj, np.ndarray):
        if obj.dtype.kind not in "biuf":
            raise TypeError(f"cannot checkpoint an array of dtype {obj.dtype}")
        leaf(obj)
        return {"array": [obj.dtype.str, list(obj.shape)]}
    if isinstance(obj, (bool, np.bool_)):
        leaf(np.asarray(bool(obj)))
        return {"bool": None}
    if isinstance(obj, (int, np.integer)):
        leaf(np.asarray(int(obj), np.int64))
        return {"int": None}
    if isinstance(obj, (float, np.floating)):
        leaf(np.asarray(float(obj), np.float64))
        return {"float": None}
    if obj is None or isinstance(obj, str):
        return {"static": obj}
    if isinstance(obj, (PrecondOptions, SolverOptions)):
        return {"options": _cls_name(obj),
                "fields": json.loads(json.dumps(dataclasses.asdict(obj)))}
    if isinstance(obj, FunctionOperator):
        return {"opaque": _cls_name(obj)}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"dataclass": _cls_name(obj),
                "fields": {f.name: _flatten(getattr(obj, f.name), leaves)
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {"namedtuple": _cls_name(obj),
                "fields": {k: _flatten(getattr(obj, k), leaves)
                           for k in obj._fields}}
    if isinstance(obj, (tuple, list)):
        return {type(obj).__name__: [_flatten(v, leaves) for v in obj]}
    if isinstance(obj, dict) and all(isinstance(k, str) for k in obj):
        return {"dict": {k: _flatten(obj[k], leaves) for k in sorted(obj)}}
    raise TypeError(f"cannot checkpoint an object of type {_cls_name(obj)}")


def _build(sig, leaves, template, device):
    """The object of signature node ``sig`` with the next leaves of the
    iterator ``leaves``, in the order ``_flatten`` took them (fields in
    declaration order, dict keys sorted).  ``template`` (or None) is the
    object in the same place of the caller's template."""
    kind = next(k for k in sig if k != "fields")
    if kind == "tensor":
        arr = np.require(next(leaves), requirements=["W"])
        return torch.from_numpy(arr).to(
            device if template is None else template.device)
    if kind == "array":
        return np.array(next(leaves))
    if kind in _SCALARS:
        return _SCALARS[kind](next(leaves))
    if kind == "static":
        return sig["static"]
    if kind == "options":
        return _cls(sig["options"])(**sig["fields"])
    if kind == "opaque":
        if template is None:
            raise ValueError(f"a {sig['opaque']} holds a callable: load it "
                             "into a template that supplies one")
        return template
    if kind in ("dataclass", "namedtuple"):
        cls = _cls(sig[kind])
        names = ([f.name for f in dataclasses.fields(cls)]
                 if kind == "dataclass" else cls._fields)
        return cls(**{k: _build(sig["fields"][k], leaves,
                                getattr(template, k, None), device)
                      for k in names})
    if kind in ("tuple", "list"):
        items = [_build(s, leaves, None if template is None else template[i],
                        device) for i, s in enumerate(sig[kind])]
        return tuple(items) if kind == "tuple" else items
    if kind == "dict":
        return {k: _build(sig["dict"][k], leaves,
                          None if template is None else template[k], device)
                for k in sorted(sig["dict"])}
    raise ValueError(f"unknown checkpoint node {kind!r}")


def save_pytree(obj, path: str) -> None:
    """Write ``obj``'s leaves and structure signature to ``path`` (.npz,
    uncompressed: a factor of several GiB is written at disk speed)."""
    leaves: list = []
    sig = json.dumps(_flatten(obj, leaves), sort_keys=True)
    arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    arrays[SIGNATURE_KEY] = np.frombuffer(sig.encode(), dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def load_pytree(template, path: str, device=None):
    """Load what ``save_pytree`` wrote.

    With ``template=None`` the object is rebuilt from the file alone, its
    tensors on ``device`` (the CUDA card by default, "cpu" on request).
    Otherwise the stored signature must be the template's (ValueError
    "...mismatch..." when not), each tensor goes to the device of the
    template's tensor in its place, and the template supplies the
    callables a file cannot hold."""
    if template is None:
        device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        stored = bytes(data[SIGNATURE_KEY]).decode()
        if template is not None:
            tsig = json.dumps(_flatten(template, None), sort_keys=True)
            if stored != tsig:
                at = next((i for i, (a, b) in enumerate(zip(stored, tsig))
                           if a != b), min(len(stored), len(tsig)))
                lo = max(0, at - 120)
                raise ValueError(
                    f"checkpoint structure mismatch at character {at}:\n"
                    f"  stored:   ...{stored[lo:at + 80]}\n"
                    f"  template: ...{tsig[lo:at + 80]}")
        leaves = iter([data[f"leaf_{i}"]
                       for i in range(len(data.files) - 1)])
        return _build(json.loads(stored), leaves, template, device)
