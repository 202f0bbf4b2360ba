"""Fault-tolerant checkpoints in the reference's file format: atomic writes,
manifest integrity hashes, latest-valid discovery, retrying restore.

Layout per step, as ``repro/train/checkpoint.py`` writes it:
  <dir>/step_<N>.npz          flat path-keyed arrays (params + opt state + extra)
  <dir>/step_<N>.json         manifest: step, leaf index, sha256 of the npz

Leaf names are the ``/``-joined dict keys of the reference's tree: the
port's per-layer lists are stacked back into ``[L, ...]`` leaves
(``interop.params_to_numpy``) and written in the reference's order (dict
keys sorted), so a checkpoint crosses between the two packages both ways
and restores bitwise. Writes are staged in a private temp directory and
published with two ``os.replace`` renames, npz first, manifest last: the
manifest rename is the commit point, so a crash at any earlier moment
leaves the previous step the latest valid one (the ``checkpoint_save``
fault site drives both windows). ``restore`` verifies the hash and
retries transient read failures (``checkpoint_read``) with capped
exponential backoff.

Checkpoints are mesh-agnostic (elastic restart): ``save`` gathers every
DTensor leaf to its full value first (all ranks take part; rank 0 writes),
and ``restore(..., shardings=)`` places each leaf onto the layout given
for it, whatever layout saved it.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.interop import params_to_numpy
from repro_torch.parallel.sharding import gather
from repro_torch.testing import faults

_STEP_RE = re.compile(r"step_(\d+)\.json$")

# Transient-read retry policy: attempts and the base backoff (doubled per
# retry, capped), the reference's.
RESTORE_RETRIES = 3
RESTORE_BACKOFF_S = 0.05
RESTORE_BACKOFF_CAP_S = 0.5


def _flatten(tree: Any, prefix: str = "") -> dict:
    """Reference-layout numpy tree -> {"a/b/c": array}, keys sorted at
    every level (the reference's flattening order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save(ckpt_dir: str, step: int, state: Any) -> str:
    """Atomically persist ``state`` (a tree of tensors: dicts, per-layer
    lists) for ``step``; returns the npz's path. The temp directory is
    removed on every exit path. DTensor leaves are gathered to their full
    values (a collective: every rank calls ``save``); in a process group
    only rank 0 writes."""
    flat = _flatten(params_to_numpy(gather(state)))
    npz_path = os.path.join(ckpt_dir, f"step_{step}.npz")
    man_path = os.path.join(ckpt_dir, f"step_{step}.json")
    if dist.is_initialized() and dist.get_rank() != 0:
        return npz_path
    os.makedirs(ckpt_dir, exist_ok=True)
    stage = os.path.join(ckpt_dir, f".tmp_step_{step}_{os.getpid()}")
    os.makedirs(stage, exist_ok=True)
    try:
        stage_npz = os.path.join(stage, "ckpt.npz")
        with open(stage_npz, "wb") as f:
            np.savez(f, **flat)
        manifest = {"step": step, "leaves": sorted(flat),
                    "sha256": _sha256(stage_npz)}
        stage_man = os.path.join(stage, "ckpt.json")
        with open(stage_man, "w") as f:
            json.dump(manifest, f)
        # Crash window 1: everything staged, nothing published.
        faults.maybe_fail("checkpoint_save")
        os.replace(stage_npz, npz_path)
        # Crash window 2: npz published, manifest not — the step stays
        # invisible to latest_valid_step (the manifest is the commit point).
        faults.maybe_fail("checkpoint_save")
        os.replace(stage_man, man_path)
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    return npz_path


def available_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def _verify(ckpt_dir: str, step: int) -> bool:
    man_path = os.path.join(ckpt_dir, f"step_{step}.json")
    npz_path = os.path.join(ckpt_dir, f"step_{step}.npz")
    try:
        with open(man_path) as f:
            manifest = json.load(f)
        return manifest["sha256"] == _sha256(npz_path)
    except (OSError, KeyError, json.JSONDecodeError):
        return False


def latest_valid_step(ckpt_dir: str) -> Optional[int]:
    for step in reversed(available_steps(ckpt_dir)):
        if _verify(ckpt_dir, step):
            return step
    return None


def _load_npz_with_retry(path: str):
    """``np.load`` with capped-backoff retries on transient OSErrors; a
    fault that persists through every attempt propagates."""
    delay = RESTORE_BACKOFF_S
    for attempt in range(RESTORE_RETRIES):
        try:
            faults.maybe_fail("checkpoint_read")
            return np.load(path)
        except OSError:
            if attempt == RESTORE_RETRIES - 1:
                raise
            time.sleep(delay)
            delay = min(delay * 2, RESTORE_BACKOFF_CAP_S)
    raise AssertionError("unreachable")


class _Leaves:
    """The npz's arrays, each read once however many layers take a slice."""

    def __init__(self, data):
        self.data, self.cache = data, {}

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self.cache:
            if name not in self.data:
                raise KeyError(f"checkpoint missing leaf {name}")
            self.cache[name] = self.data[name]
        return self.cache[name]


def _rebuild(tmpl: Any, name: str, leaves: _Leaves, layer=None,
             sharding=None) -> Any:
    """The template's structure with every leaf read from the checkpoint:
    a list's i-th entry takes slice i of its stacked leaves; shapes are
    checked against the template's, dtype and device taken from it; a
    leaf whose ``sharding`` (a congruent tree's entry) is given is placed
    by it."""
    if isinstance(tmpl, dict):
        return {k: _rebuild(v, f"{name}{k}/", leaves, layer,
                            None if sharding is None else sharding[k])
                for k, v in tmpl.items()}
    if isinstance(tmpl, list):
        return [_rebuild(v, name, leaves, (i, len(tmpl)),
                         None if sharding is None else sharding[i])
                for i, v in enumerate(tmpl)]
    key = name[:-1]
    arr = leaves[key]
    want = tuple(tmpl.shape)
    if layer is not None:
        want = (layer[1],) + want
    if tuple(arr.shape) != want:
        raise ValueError(f"{key}: shape {arr.shape} != {want}")
    if layer is not None:
        arr = arr[layer[0]]
    out = torch.from_numpy(np.array(arr, copy=True)).to(
        device=tmpl.device, dtype=tmpl.dtype)
    if sharding is None:
        return out
    from torch.distributed.tensor import distribute_tensor
    sharding.check(out.shape, key)
    return distribute_tensor(out, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None,
            shardings: Any = None) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` (shapes validated; each
    leaf takes the template leaf's dtype and device): ``(tree, step)``.
    ``shardings``: a tree congruent with ``template`` of
    ``parallel.mesh.NamedSharding``s (``parallel.sharding.named_shardings``),
    each leaf placed by its own: a checkpoint restores onto another mesh
    than the one that saved it (elastic restart). Placements a leaf cannot
    take raise. Transient read failures are retried
    (:func:`_load_npz_with_retry`)."""
    if step is None:
        step = latest_valid_step(ckpt_dir)   # verified on the way
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")
    elif not _verify(ckpt_dir, step):
        raise IOError(f"checkpoint step {step} failed integrity check")
    data = _load_npz_with_retry(os.path.join(ckpt_dir, f"step_{step}.npz"))
    with data:
        return _rebuild(template, "", _Leaves(data), sharding=shardings), step


def cleanup(ckpt_dir: str, keep_last: int = 3) -> None:
    steps = [s for s in available_steps(ckpt_dir) if _verify(ckpt_dir, s)]
    for step in steps[:-keep_last]:
        for suffix in (".npz", ".json"):
            try:
                os.remove(os.path.join(ckpt_dir, f"step_{step}{suffix}"))
            except OSError:
                pass
