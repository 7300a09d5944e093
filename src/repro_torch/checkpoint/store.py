"""Iteration-level checkpointing (paper §8) — crash-atomic.

The port of ``repro.checkpoint.store``. LeapGNN checkpoints at *iteration*
boundaries (after gradients are applied and partial-gradient state is
cleared), so a checkpoint needs only (iteration id, model parameters,
optimizer state) — no in-flight time-step state: an ``npz`` of flattened
tree leaves plus a JSON manifest, atomic rename, and a ``latest`` pointer.

Layout, shared with the reference so that either package loads the
other's checkpoints: ``leaf_{i}`` arrays in ``step-<step>.npz`` and a
``step-<step>.json`` manifest with ``step``, ``num_leaves``, ``dtypes``,
``treedef`` (a description string; nothing parses it) and ``extra``. The
leaves are numbered in ``jax.tree.leaves`` order, which :func:`tree_leaves`
reproduces without JAX: dict keys sorted, NamedTuple fields in order
(``AdamState`` is ``step``, ``mu``, ``nu``), lists in order, None skipped,
and a GNN module by its :meth:`leaves` (the reference's parameter-tree
order). bfloat16 and float8 leaves are stored as same-width integer views
under their dtype name, as the reference stores them, and decoded into
torch dtypes with torch alone.

Durability contract (repro_torch.resilience): every file lands via
``temp file → flush → fsync → os.replace`` and the directory entry is
fsynced after, so a SIGKILL at ANY instant leaves either the complete new
checkpoint or the complete previous one — never a torn file under a final
name. Older checkpoints are pruned only *after* the new one (npz +
manifest + ``latest``) is durable. :func:`load_checkpoint` with
``step=None`` validates candidates newest-first and falls back past a
truncated or corrupt one with a ``RuntimeWarning``; an explicitly
requested ``step`` fails loudly.

Loading copies into the template: a tensor leaf of ``tree_like`` receives
the stored values in place (on its own device, in its own dtype) and the
returned tree holds those same tensors; any other leaf is replaced by the
stored array (a torch tensor for bfloat16/float8, else numpy).
"""
from __future__ import annotations

import json
import os
import tempfile
import warnings
import zipfile
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import is_module, is_namedtuple, tree_leaves
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.trace import span as _obs_span


class CheckpointCorrupt(RuntimeError):
    """A checkpoint's files exist but cannot be decoded (truncated write,
    bit rot, missing manifest) — resume should fall back, not crash."""


# ---------------------------------------------------------------------------
# Trees in jax.tree.leaves order
# ---------------------------------------------------------------------------

def _describe(tree: Any) -> str:
    """A treedef-like description (``*`` per leaf) for the manifest."""
    if tree is None:
        return "None"
    if is_module(tree):
        return f"{type(tree).__name__}[{len(tree.leaves())} leaves]"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if is_namedtuple(tree):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{f}={_describe(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves taken from the iterator
    ``leaves`` in :func:`tree_leaves` order (a module's tensors are
    filled in place, so the module itself comes back)."""
    if tree is None:
        return None
    if is_module(tree):
        for _ in tree.leaves():
            next(leaves)
        return tree
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if is_namedtuple(tree):
        return type(tree)(*[_rebuild(v, leaves) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


# ---------------------------------------------------------------------------
# Encoding: npz cannot store bfloat16/float8; view them as same-width ints
# ---------------------------------------------------------------------------

_EXOTIC = {"bfloat16": (np.uint16, torch.int16),
           "float8_e4m3fn": (np.uint8, torch.uint8),
           "float8_e5m2": (np.uint8, torch.uint8)}


def _encode(x) -> tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if name in _EXOTIC:
            np_int, t_int = _EXOTIC[name]
            return t.contiguous().view(t_int).numpy().view(np_int), name
        return t.numpy(), name
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, name: str):
    if name in _EXOTIC:
        _, t_int = _EXOTIC[name]
        raw = torch.from_numpy(np.asarray(arr, order="C")).view(t_int)
        return raw.view(getattr(torch, name))
    return arr


def _json_safe(obj):
    """Manifest ``extra`` payloads routinely carry numpy scalars (budget
    bucket sizes, epoch stats); coerce them instead of crashing the save."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON-serializable: {type(obj)!r}")


def _fsync_dir(directory: Path) -> None:
    """Make renamed directory entries durable (no-op where unsupported)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(directory: Path, final: Path, payload) -> None:
    """temp file → flush → fsync → os.replace under ``final``'s directory.
    ``payload(f)`` writes to the open binary file object."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            payload(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(directory: str | Path, step: int, tree: Any,
                    extra: Optional[dict] = None, keep: int = 3) -> Path:
    """Crash-atomically write ``step-<step>.npz`` + manifest; prune old
    ones only once the new checkpoint is fully durable."""
    with _obs_span("ckpt.save", step=int(step)):
        _obs_metrics.inc("ckpt.saves")
        return _save_checkpoint(directory, step, tree, extra, keep)


def _save_checkpoint(directory, step, tree, extra, keep) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves(tree)
    arrays, dtypes = {}, []
    for i, x in enumerate(leaves):
        enc, name = _encode(x)
        arrays[f"leaf_{i}"] = enc
        dtypes.append(name)
    manifest = {"step": int(step), "num_leaves": len(leaves),
                "dtypes": dtypes, "treedef": _describe(tree),
                "extra": extra or {}}

    final = directory / f"step-{step:08d}.npz"
    _atomic_write(directory, final, lambda f: np.savez(f, **arrays))
    # manifest second: a crash between the two leaves an npz without a
    # manifest, which valid_steps/load treat as incomplete and skip
    blob = json.dumps(manifest, default=_json_safe).encode()
    _atomic_write(directory, directory / f"step-{step:08d}.json",
                  lambda f: f.write(blob))
    _atomic_write(directory, directory / "latest",
                  lambda f: f.write(str(step).encode()))
    _fsync_dir(directory)

    # previous checkpoints survive until here — the new one is durable now
    gc_checkpoints(directory, keep)
    return final


# Test seam: called with the step id between a checkpoint's manifest and
# npz deletions, so a kill-during-GC test can stop the process at the
# worst possible instant. Never set outside tests.
_GC_FAULT_HOOK = None


def gc_checkpoints(directory: str | Path, keep: int) -> list[int]:
    """Keep-last-``keep`` retention sweep; returns the steps deleted.

    Crash-safe by ordering, not by locking:

    * the step ``latest`` points at is never deleted;
    * within one checkpoint the **manifest is deleted before the npz**: a
      kill between the two leaves an npz-only orphan, which
      :func:`valid_steps`/:func:`load_checkpoint` already treat as
      incomplete and which the *next* sweep deletes (the glob is
      npz-driven, so the reverse order would strand manifest orphans);
    * deletion proceeds oldest-first.

    ``keep <= 0`` disables retention (nothing is deleted)."""
    directory = Path(directory)
    if keep <= 0:
        return []
    keep_set = set(valid_steps(directory)[-keep:])
    pinned = latest_step(directory)
    if pinned is not None:
        keep_set.add(pinned)
    deleted: list[int] = []
    for p in sorted(directory.glob("step-*.npz")):
        try:
            step = int(p.stem.split("-")[1])
        except (IndexError, ValueError):
            continue
        if step in keep_set:
            continue
        p.with_suffix(".json").unlink(missing_ok=True)
        if _GC_FAULT_HOOK is not None:
            _GC_FAULT_HOOK(step)
        p.unlink(missing_ok=True)
        deleted.append(step)
    if deleted:
        _fsync_dir(directory)
        _obs_metrics.inc("ckpt.gc_deleted", len(deleted))
    return deleted


def latest_step(directory: str | Path) -> Optional[int]:
    p = Path(directory) / "latest"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def valid_steps(directory: str | Path) -> list[int]:
    """Steps whose npz AND manifest both exist, ascending (completeness by
    presence only — decode errors are caught at load time)."""
    directory = Path(directory)
    out = []
    for p in sorted(directory.glob("step-*.npz")):
        try:
            step = int(p.stem.split("-")[1])
        except (IndexError, ValueError):
            continue
        if p.with_suffix(".json").exists():
            out.append(step)
    return out


def _fill(template, value):
    """One restored leaf: copied into a tensor template, else the stored
    value itself."""
    if not isinstance(template, torch.Tensor):
        return value
    src = value if isinstance(value, torch.Tensor) else torch.from_numpy(
        np.asarray(value, order="C"))
    with torch.no_grad():
        template.copy_(src)
    return template


def _load_step(directory: Path, step: int, tree_like: Any
               ) -> tuple[Any, int, dict]:
    """Decode one checkpoint. Raises CheckpointCorrupt for anything that
    smells like a torn or rotten file; a template/leaf-count mismatch is a
    caller-contract ValueError and propagates as such (falling back to an
    older checkpoint would silently resume the wrong run). Every leaf is
    decoded before any is copied into the template."""
    npz_path = directory / f"step-{step:08d}.npz"
    man_path = directory / f"step-{step:08d}.json"
    try:
        manifest = json.loads(man_path.read_text())
        data = np.load(npz_path)
    except FileNotFoundError:
        raise
    except (json.JSONDecodeError, zipfile.BadZipFile, OSError,
            ValueError) as e:
        raise CheckpointCorrupt(f"step {step}: unreadable ({e})") from e
    leaves = tree_leaves(tree_like)
    if len(leaves) != manifest["num_leaves"]:
        raise ValueError(
            f"leaf count mismatch: template {len(leaves)} vs "
            f"checkpoint {manifest['num_leaves']}")
    try:
        restored = [_decode(data[f"leaf_{i}"], manifest["dtypes"][i])
                    for i in range(len(leaves))]
    except (KeyError, zipfile.BadZipFile, zlib.error, OSError,
            ValueError, EOFError) as e:
        # npz members decompress lazily — truncation surfaces here
        raise CheckpointCorrupt(f"step {step}: truncated ({e})") from e
    for t, v in zip(leaves, restored):
        if isinstance(t, torch.Tensor) and \
                tuple(t.shape) != tuple(v.shape):
            raise ValueError(f"leaf shape mismatch: template "
                             f"{tuple(t.shape)} vs checkpoint "
                             f"{tuple(v.shape)}")
    filled = iter([_fill(t, v) for t, v in zip(leaves, restored)])
    return _rebuild(tree_like, filled), step, manifest["extra"]


def load_checkpoint(directory: str | Path, tree_like: Any,
                    step: Optional[int] = None) -> tuple[Any, int, dict]:
    """Restore into the structure of ``tree_like`` (see the module doc for
    how tensor leaves are filled). Returns (tree, step, extra).

    With ``step=None`` candidates are tried newest-first: a truncated or
    otherwise corrupt checkpoint is skipped with a warning and the
    previous durable one is restored. An explicit ``step`` fails loudly
    instead — the caller asked for that exact state."""
    with _obs_span("ckpt.load", step=-1 if step is None else int(step)):
        _obs_metrics.inc("ckpt.loads")
        return _load_checkpoint(directory, tree_like, step)


def _load_checkpoint(directory, tree_like, step) -> tuple[Any, int, dict]:
    directory = Path(directory)
    if step is not None:
        return _load_step(directory, step, tree_like)
    candidates = valid_steps(directory)
    latest = latest_step(directory)
    if latest is not None and latest not in candidates:
        # a 'latest' pointing at an incomplete pair is itself a crash
        # artifact; try the files that exist
        warnings.warn(f"checkpoint 'latest'={latest} is incomplete in "
                      f"{directory}; falling back", RuntimeWarning)
    if not candidates:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    last_err: Optional[Exception] = None
    for cand in reversed(candidates):
        try:
            return _load_step(directory, cand, tree_like)
        except CheckpointCorrupt as e:
            warnings.warn(
                f"skipping corrupt checkpoint step {cand} in {directory} "
                f"({e}); falling back to the previous one", RuntimeWarning)
            last_err = e
    raise CheckpointCorrupt(
        f"every checkpoint in {directory} is corrupt") from last_err
