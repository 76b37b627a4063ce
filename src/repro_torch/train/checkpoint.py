"""Checkpoints of a state tree, atomic and optionally written in the
background.

Counterpart of the parts of ``repro/train/checkpoint.py`` that the
simulator's :class:`repro_torch.core.health.SimCheckpointer` uses, in a
torch-native format (the reference's files are not read):

  <dir>/step_<N>/
    manifest.json   flat key -> {shape, dtype}, plus user metadata
    tensors.pt      ``torch.save`` of a flat key -> CPU tensor dict

A tree is nested dicts, lists, tuples and NamedTuples of tensors and
Python scalars (an int such as the ring pointer is saved as a 0-d int64
tensor and restored as an int), and modules, whose parameters are
leaves (an LM's :class:`repro_torch.train.TrainState`).  Leaves are
copied to the host *before* :func:`save_checkpoint` returns, always into
new memory, so the saved state is the state at call time even when the
caller goes on writing its tensors in place and the write runs on a
background thread (``async_save=True``); the returned
:class:`CheckpointHandle` must be joined, and ``join`` re-raises anything
the writer raised.  Saves are atomic (a temporary directory, then a
rename), so a crash mid-save never corrupts the newest complete step.

Restores are shape- AND dtype-checked against a template tree: a Q19.12
int32 carry restored into a float32 target would otherwise be cast
silently.  Each restored tensor goes onto its template leaf's device; a
template module is filled in place (after every leaf of the tree is
checked), so a model's parameters are never held twice on the device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import torch


def _items(node, path: str):
    """(flat key, leaf) pairs of a tree, in a fixed order."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _items(v, f"{path}['{k}']/")
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for k in node._fields:
            yield from _items(getattr(node, k), f"{path}.{k}/")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _items(v, f"{path}[{i}]/")
    elif isinstance(node, torch.nn.Module):
        for k, p in node.named_parameters():
            yield f"{path}.{k}", p
    elif node is not None:
        yield path.rstrip("/"), node


def flatten(tree) -> dict:
    """Flat key -> leaf dict of ``tree``; keys name the path, e.g.
    ``['carry']/.lif/.v``, ``['records']/['raster']`` or, for a module's
    parameter, ``.params/.stack.0.mixer.wq``."""
    return dict(_items(tree, ""))


def _host(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, bool):
        return torch.tensor(leaf)
    if isinstance(leaf, int):
        return torch.tensor(leaf, dtype=torch.int64)
    if isinstance(leaf, float):
        return torch.tensor(leaf, dtype=torch.float64)
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


class CheckpointHandle:
    """Joinable background-write handle.  ``join()`` blocks until the
    write finishes and re-raises anything the write thread raised."""

    def __init__(self, fn):
        self._error: Optional[BaseException] = None

        def guarded():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised in join
                self._error = e

        self._thread = threading.Thread(target=guarded, daemon=True)
        self._thread.start()

    def join(self) -> None:
        self._thread.join()
        if self._error is not None:
            raise self._error


def save_checkpoint(directory: str, step: int, tree,
                    metadata: dict | None = None, async_save: bool = False
                    ) -> Optional[CheckpointHandle]:
    """Write ``tree`` as step ``step`` under ``directory``.  Blocking by
    default; ``async_save`` runs the file write on a background thread
    after the copy to the host and returns a :class:`CheckpointHandle`
    the caller must join."""
    host = {k: _host(v) for k, v in flatten(tree).items()}

    def write():
        tmp = os.path.join(directory, f".tmp_step_{step}")
        final = os.path.join(directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        torch.save(host, os.path.join(tmp, "tensors.pt"))
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(v.shape),
                         "dtype": str(v.dtype).removeprefix("torch.")}
                     for k, v in host.items()},
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_save:
        return CheckpointHandle(write)
    write()
    return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _load(directory: str, step: int) -> tuple[dict, dict]:
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tensors = torch.load(os.path.join(path, "tensors.pt"), map_location="cpu",
                         weights_only=True)
    return tensors, manifest


def read_checkpoint_arrays(directory: str, step: int
                           ) -> tuple[dict[str, torch.Tensor], dict]:
    """Raw flat key -> CPU tensor dict + user metadata, no template
    needed (for subtrees whose shapes vary, such as the records so far,
    whose time axis grows every chunk)."""
    tensors, manifest = _load(directory, step)
    return tensors, manifest["metadata"]


def _rebuild(node, path: str, z: dict):
    if isinstance(node, dict):
        return {k: _rebuild(v, f"{path}['{k}']/", z) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_rebuild(getattr(node, k), f"{path}.{k}/", z)
                            for k in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, f"{path}[{i}]/", z)
                          for i, v in enumerate(node))
    if isinstance(node, torch.nn.Module):
        with torch.no_grad():
            for k, p in node.named_parameters():
                p.copy_(z[f"{path}.{k}"])
        return node
    if node is None:
        return None
    arr = z[path.rstrip("/")]
    if isinstance(node, torch.Tensor):
        return arr.to(node.device)
    return type(node)(arr.item())


def _check(z: dict, key: str, leaf) -> None:
    arr = z[key]
    tgt = leaf if isinstance(leaf, torch.Tensor) else _host(leaf)
    if tuple(arr.shape) != tuple(tgt.shape):
        raise ValueError(f"shape mismatch for {key}: "
                         f"ckpt {tuple(arr.shape)} vs target "
                         f"{tuple(tgt.shape)}")
    if arr.dtype != tgt.dtype:
        # a silent cast here corrupts the bit-faithful Q19.12 path
        raise ValueError(f"dtype mismatch for {key}: "
                         f"ckpt {arr.dtype} vs target {tgt.dtype}")


def unflatten(target_tree, flat: dict):
    """The inverse of :func:`flatten`: ``target_tree`` rebuilt from the
    flat key -> tensor dict, each leaf checked against the target's shape
    and dtype and put on its device (a module's parameters copied into
    it).  Keys of ``flat`` that the target
    does not reference are ignored (a subtree restore).  Every leaf is
    checked before any is written, so a refused restore leaves a template
    module as it was."""
    for key, leaf in _items(target_tree, ""):
        _check(flat, key, leaf)
    return _rebuild(target_tree, "", flat)


def restore_checkpoint(directory: str, step: int, target_tree):
    """``target_tree``: a tree of the same structure whose leaves give
    each restored leaf's shape, dtype and device (:func:`unflatten`).
    Returns ``(tree, metadata)``."""
    tensors, manifest = _load(directory, step)
    return unflatten(target_tree, tensors), manifest["metadata"]


__all__ = ["CheckpointHandle", "flatten", "latest_step",
           "read_checkpoint_arrays", "restore_checkpoint", "save_checkpoint",
           "unflatten"]
