"""Atomic, async-capable checkpointer in the JAX package's on-disk format.

Counterpart of ``src/repro/checkpoint/checkpointer.py``. Format: one
directory per step —
    ckpt_dir/step_000123/
        meta.json                 (step, flat key list, dtypes, shapes, extra)
        <flat-key>.npy            (one file per leaf)
    ckpt_dir/step_000123.done     (commit marker)

A leaf's key is its path through the tree, dict keys and list indices joined
by ``"::"``, dicts walked in sorted key order (the order of
``jax.tree_util.tree_flatten_with_path``); its file is the key with ``/``
replaced, plus ``.npy``. bf16 is stored as a ``uint16`` view and fp8 (e4m3fn,
e5m2) as a ``uint8`` view, with the logical dtype's name in ``meta.json``.
So either package reads what the other wrote, file for file.

Writes go to ``step_X.tmp`` and are renamed before the commit marker is
written and fsynced: a crash mid-write never corrupts the latest checkpoint.
``latest_step`` takes the newest ``.done`` whose directory holds a
``meta.json``, falling back past stale markers left by an interrupted
re-save; orphaned ``step_X.tmp`` buffers are collected on construction.

Trees are nested ``dict``s / ``list``s / ``tuple``s of tensors (any device),
numpy arrays, or ``Stacked`` leaves (tensors stored as one stacked array,
without that stack being made on their device). ``save_async`` copies every
leaf to host memory before it returns, so the caller may update its tensors
in place at once (the port's optimizer does); a worker thread writes the
copies. ``restore(target=...)`` copies into the target's tensors in place,
so parameters stay the model's own; a dtype or shape that differs from the
checkpoint's raises.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

_SEP = "::"

# Logical dtype name -> (torch dtype, numpy storage type of the same width).
# numpy has no bf16 or fp8 without ml_dtypes, so their bits travel as
# unsigned integers, as the JAX package stores them.
_EXOTIC = {"bfloat16": (torch.bfloat16, np.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
           "float8_e5m2": (torch.float8_e5m2, np.uint8)}
_TORCH_TO_EXOTIC = {tdt: name for name, (tdt, _) in _EXOTIC.items()}
# The integer type of each storage width that both numpy and torch know.
_BITS = {np.uint16: (np.int16, torch.int16), np.uint8: (np.uint8, torch.uint8)}

Tree = Any


def _walk(tree: Tree, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in the JAX package's order: dict keys sorted, sequences
    by index; None is an empty subtree, as in JAX."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    elif tree is not None:
        yield _SEP.join(prefix), tree


def _rebuild(tree: Tree, leaves: Dict[str, Any],
             prefix: Tuple[str, ...] = ()) -> Tree:
    """``tree``'s structure with each leaf replaced by ``leaves[key]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return None if tree is None else leaves[_SEP.join(prefix)]


class Stacked:
    """A leaf held as its pieces, saved and restored as ``torch.stack(
    pieces)``: one array, one file. The stack is never made on the pieces'
    device: a save copies each piece into its slice of a host array, a
    restore copies each slice into its piece in place. (The port keeps one
    tensor a layer where the JAX package's tree stacks the layers; this
    carries one to the other with no second copy of the state on the card.)
    """

    def __init__(self, pieces):
        self.pieces = [p.detach() for p in pieces]
        self.dtype = self.pieces[0].dtype
        self.shape = (len(self.pieces),) + tuple(self.pieces[0].shape)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A private host copy of ``leaf`` as numpy storage, and its logical
    dtype's name. The copy never aliases the leaf."""
    if isinstance(leaf, Stacked):
        t = torch.empty(leaf.shape, dtype=leaf.dtype)
        for row, piece in zip(t, leaf.pieces):
            row.copy_(piece)          # to pageable memory: done on return
    elif torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", memory_format=torch.contiguous_format,
                             copy=True)
    else:
        arr = np.array(leaf, order="C", copy=True)
        name = str(arr.dtype)
        if name in _EXOTIC:                 # an ml_dtypes array of a caller
            return arr.view(_EXOTIC[name][1]), name
        return arr, name
    name = _TORCH_TO_EXOTIC.get(t.dtype)
    if name is not None:
        storage = _EXOTIC[name][1]
        return t.view(_BITS[storage][1]).numpy().view(storage), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _as_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """Stored numpy array -> a CPU tensor of its logical dtype."""
    if name in _EXOTIC:
        tdt, storage = _EXOTIC[name]
        np_bits, torch_bits = _BITS[storage]
        return torch.from_numpy(arr.view(np_bits)).view(torch_bits).view(tdt)
    return torch.from_numpy(arr)


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf) or isinstance(leaf, Stacked):
        return _TORCH_TO_EXOTIC.get(leaf.dtype) or str(
            torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # GC orphaned write buffers from a previous crashed save: a
        # step_X.tmp dir is by construction uncommitted and unreadable.
        for name in os.listdir(directory):
            if name.startswith("step_") and name.endswith(".tmp"):
                path = os.path.join(directory, name)
                if os.path.isdir(path):
                    shutil.rmtree(path)

    # ------------------------------------------------------------------ #
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, tree: Tree, extra: Optional[Dict] = None) -> str:
        """Blocking atomic save."""
        return self._write(step, [(k, *_to_host(v)) for k, v in _walk(tree)],
                           extra)

    def _write(self, step: int, flat: List[Tuple[str, np.ndarray, str]],
               extra: Optional[Dict]) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        meta = {"step": step, "keys": [], "extra": extra or {}}
        for key, arr, logical in flat:
            fname = key.replace("/", "_") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            meta["keys"].append(
                {"key": key, "file": fname, "dtype": logical,
                 "shape": list(arr.shape)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        done = final + ".done"
        if os.path.exists(final):
            # Re-save of an existing step: drop the commit marker before
            # touching the directory, so a crash inside the swap window
            # leaves no marker pointing at a missing/partial checkpoint.
            if os.path.exists(done):
                os.remove(done)
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(done, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        return final

    def save_async(self, step: int, tree: Tree,
                   extra: Optional[Dict] = None) -> None:
        """Non-blocking save: every leaf is copied to host memory before
        this returns (so later in-place updates of the tree's tensors do not
        reach the checkpoint); a worker thread writes the copies."""
        flat = [(k, *_to_host(v)) for k, v in _walk(tree)]
        self.wait()
        self._thread = threading.Thread(
            target=self._write_in_thread, args=(step, flat, extra),
            daemon=True)
        self._thread.start()

    def _write_in_thread(self, step, flat, extra) -> None:
        try:
            self._write(step, flat, extra)
        except BaseException as exc:   # handed to the caller by wait()
            self._error = exc

    def wait(self) -> None:
        """Join the in-flight async save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    # ------------------------------------------------------------------ #
    def _committed_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".done"):
                try:
                    steps.append(int(name[len("step_"):-len(".done")]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """Newest step that is both committed (``.done``) and readable
        (``meta.json`` present).  A stale marker left by an interrupted
        re-save is skipped, falling back to the next-newest step."""
        for s in reversed(self._committed_steps()):
            if os.path.isfile(os.path.join(self._step_dir(s), "meta.json")):
                return s
        return None

    def restore(self, step: Optional[int] = None, target: Tree = None
                ) -> Tuple[Any, Dict]:
        """Returns (tree, extra). Without ``target``: the flat dict of
        leaves by key, numpy arrays (bf16 and fp8 leaves, which numpy cannot
        hold without ml_dtypes, as CPU tensors of their dtype). With
        ``target``: its structure, each tensor (or ``Stacked``) leaf the
        target's own with the checkpoint's values copied in, each numpy leaf
        a new array;
        a leaf whose dtype or shape differs from the checkpoint's raises
        ``ValueError``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        by_key = {e["key"]: e for e in meta["keys"]}

        def _load(e) -> np.ndarray:
            return np.load(os.path.join(d, e["file"]))

        if target is None:
            out = {}
            for e in meta["keys"]:
                arr = _load(e)
                out[e["key"]] = (_as_tensor(arr, e["dtype"])
                                 if e["dtype"] in _EXOTIC else arr)
            return out, meta.get("extra", {})

        flat = list(_walk(target))
        missing = sorted(k for k, _ in flat if k not in by_key)
        unexpected = sorted(set(by_key) - {k for k, _ in flat})
        if missing or unexpected:
            raise KeyError(
                f"checkpoint step {step} does not match the target tree: "
                f"missing from checkpoint: {missing or 'none'}; "
                f"unexpected in checkpoint: {unexpected or 'none'}")
        for key, leaf in flat:
            e = by_key[key]
            shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
            if _dtype_name(leaf) != e["dtype"] or shape != tuple(e["shape"]):
                raise ValueError(
                    f"checkpoint step {step}, leaf {key!r}: stored "
                    f"{e['dtype']} {tuple(e['shape'])}, target "
                    f"{_dtype_name(leaf)} {shape}")
        leaves = {}
        with torch.no_grad():
            for key, leaf in flat:
                e = by_key[key]
                arr = _load(e)
                if isinstance(leaf, Stacked):
                    for piece, row in zip(leaf.pieces,
                                          _as_tensor(arr, e["dtype"])):
                        piece.copy_(row)
                    leaves[key] = leaf
                elif torch.is_tensor(leaf):
                    leaf.copy_(_as_tensor(arr, e["dtype"]))
                    leaves[key] = leaf
                else:
                    leaves[key] = (arr.view(np.asarray(leaf).dtype)
                                   if e["dtype"] in _EXOTIC else arr)
        return _rebuild(target, leaves), meta.get("extra", {})


class CheckpointManager:
    """Retention + cadence policy around a Checkpointer."""

    def __init__(self, directory: str, interval: int = 100,
                 keep: int = 3, async_save: bool = True):
        self.ckpt = Checkpointer(directory)
        self.interval = interval
        self.keep = keep
        self.async_save = async_save

    def maybe_save(self, step: int, tree: Union[Tree, Callable[[], Tree]],
                   extra=None, force=False) -> bool:
        """Save at the cadence (or when forced). ``tree`` may be a function
        that builds it, called only when this step is saved."""
        if not force and (self.interval <= 0 or step % self.interval != 0):
            return False
        if force:
            # Drain any in-flight async save; skip if this step is already
            # committed (final flush after a cadence save of the same step).
            self.ckpt.wait()
            if self.latest_step() == step:
                return False
        if callable(tree):
            tree = tree()
        if self.async_save and not force:
            self.ckpt.save_async(step, tree, extra)
        else:
            self.ckpt.save(step, tree, extra)
        self._gc()
        return True

    def _gc(self) -> None:
        steps = self.ckpt._committed_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            d = self.ckpt._step_dir(s)
            for path in (d, d + ".done"):
                if os.path.isdir(path):
                    shutil.rmtree(path)
                elif os.path.exists(path):
                    os.remove(path)

    def restore_latest(self, target: Tree = None):
        return self.ckpt.restore(None, target)

    def latest_step(self) -> Optional[int]:
        return self.ckpt.latest_step()

    def wait(self) -> None:
        self.ckpt.wait()
