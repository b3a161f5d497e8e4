"""Checkpoints on disk: a manifest plus one raw-bytes shard file per piece.

Counterpart of ``repro.ckpt.checkpoint``, in the same on-disk format, so a
checkpoint moves between the two packages in both directions:

  step_XXXXXXXX/manifest.json   — step, per leaf its shape, dtype name,
                                  shard count and shard shapes, the
                                  caller's ``extra`` dict, and ``codec``
  step_XXXXXXXX/<leaf>.<i>.npz  — the raw bytes of shard i of the leaf
                                  (split along dim 0), zstd-compressed or
                                  raw as ``codec`` says

Leaves are named by their path in the (nested dict / list / tuple) tree,
joined by ``.``, in the JAX package's flattening order (dict keys sorted).
A write goes to ``<dir>.tmp`` and is renamed into place, so a crashed save
never corrupts the latest good checkpoint.

The ``codec`` key is this package's one addition: the JAX reader reads only
``leaves``, ``step`` and ``extra``.  A manifest without it means zstd, as
the JAX writer produces where ``zstandard`` is installed.  ``zstandard`` is
optional here: without it a save writes raw shards, and reading a zstd
shard raises an error that names the package — never raw bytes as data.
bfloat16 leaves (dtype name ``"bfloat16"``, the name the JAX package
writes through ``ml_dtypes``) come back as ``torch.bfloat16`` tensors,
every other leaf as a numpy array; ``ml_dtypes`` is not needed.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

Tree = Any


# --------------------------------------------------------------------- #
# codecs                                                                 #
# --------------------------------------------------------------------- #
def _zstd():
    try:
        import zstandard
    except ImportError as e:
        raise RuntimeError(
            "this checkpoint's shards are zstd-compressed and reading them needs "
            "the 'zstandard' package, which is not installed") from e
    return zstandard


def _default_codec() -> str:
    try:
        import zstandard  # noqa: F401
    except ImportError:
        return "raw"
    return "zstd"


def _encode(raw: bytes, codec: str) -> bytes:
    return _zstd().ZstdCompressor(level=3).compress(raw) if codec == "zstd" else raw


def _decode(data: bytes, codec: str) -> bytes:
    if codec == "zstd":
        return _zstd().ZstdDecompressor().decompress(data)
    if codec != "raw":
        raise ValueError(f"unknown checkpoint codec {codec!r}")
    return data


# --------------------------------------------------------------------- #
# trees                                                                  #
# --------------------------------------------------------------------- #
def _items(tree: Tree, prefix: tuple = ()):
    """(path, leaf) pairs in the JAX package's flattening order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _items(tree[key], prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _items(sub, prefix + (str(i),))
    else:
        yield prefix, tree


def _name(path: tuple) -> str:
    return ".".join(path) or "root"


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (host array of its bytes, dtype name in the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree: Tree, copy: bool = False) -> dict[str, tuple[np.ndarray, str]]:
    out = {}
    for path, leaf in _items(tree):
        arr, dtype = _host(leaf)
        out[_name(path)] = (np.array(arr, copy=True) if copy else arr, dtype)
    return out


# --------------------------------------------------------------------- #
# save / load                                                            #
# --------------------------------------------------------------------- #
def _write(directory: str, leaves: dict[str, tuple[np.ndarray, str]], step: int,
           n_shards: int, extra: dict | None) -> str:
    codec = _default_codec()
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}, "codec": codec}
    for name, (arr, dtype) in leaves.items():
        shards = max(1, min(n_shards, arr.shape[0] if arr.ndim else 1))
        pieces = np.array_split(arr, shards, axis=0) if arr.ndim else [arr]
        manifest["leaves"][name] = dict(
            shape=list(arr.shape), dtype=dtype, shards=shards,
            shard_shapes=[list(p.shape) for p in pieces])
        for i, piece in enumerate(pieces):
            with open(os.path.join(tmp, f"{name}.{i}.npz"), "wb") as f:
                f.write(_encode(np.ascontiguousarray(piece).tobytes(), codec))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, tree: Tree, step: int, n_shards: int = 4,
                    extra: dict | None = None) -> str:
    """Synchronous atomic save of a tree of tensors / arrays (zstd shards
    where ``zstandard`` is installed, else raw); returns the checkpoint's
    path."""
    return _write(directory, _flatten(tree), step, n_shards, extra)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _resolve_step(directory: str, step: int | None) -> tuple[str, dict]:
    """The checkpoint directory (the latest when ``step`` is None) and its
    manifest."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["step"] = step
    return path, manifest


def _read_leaf(path: str, name: str, meta: dict, codec: str):
    """One leaf from its shard files: a numpy array, or a torch.bfloat16
    tensor for a bfloat16 leaf."""
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype(np.int16 if bf16 else meta["dtype"])
    pieces = []
    for i in range(meta["shards"]):
        with open(os.path.join(path, f"{name}.{i}.npz"), "rb") as f:
            raw = bytearray(_decode(f.read(), codec))      # writable
        pieces.append(np.frombuffer(raw, dtype=dtype).reshape(meta["shard_shapes"][i]))
    arr = (np.concatenate(pieces, axis=0) if len(pieces) > 1 else pieces[0]
           ).reshape(meta["shape"])
    return torch.from_numpy(arr).view(torch.bfloat16) if bf16 else arr


def load_checkpoint_arrays(directory: str, step: int | None = None
                           ) -> tuple[dict[str, Any], int, dict]:
    """Template-free restore: every saved leaf on the host, by its name.

    Returns ``(arrays, step, extra)`` with ``extra`` the dict passed to
    ``save_checkpoint`` (the streamed build keeps its fingerprint there).
    """
    path, manifest = _resolve_step(directory, step)
    codec = manifest.get("codec", "zstd")
    arrays = {name: _read_leaf(path, name, meta, codec)
              for name, meta in manifest["leaves"].items()}
    return arrays, manifest["step"], manifest.get("extra", {})


def _unflatten(template: Tree, leaves: dict, prefix: tuple = ()):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten(v, leaves, prefix + (str(i),)) for i, v in enumerate(template)]
        return type(template)(out) if isinstance(template, tuple) else out
    arr = leaves[_name(prefix)]
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(arr, device=template.device)
    return arr


def load_checkpoint(directory: str, template: Tree, step: int | None = None
                    ) -> tuple[Tree, int]:
    """Restore into ``template``'s structure: a tensor leaf of the template
    comes back as a tensor on that leaf's device, any other leaf as a host
    array.  Returns (tree, step)."""
    arrays, step, _ = load_checkpoint_arrays(directory, step)
    return _unflatten(template, arrays), step


class CheckpointManager:
    """Asynchronous save, retention of the newest ``keep``, and restore."""

    def __init__(self, directory: str, keep: int = 3, n_shards: int = 4):
        self.directory = directory
        self.keep = keep
        self.n_shards = n_shards
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save_async(self, tree: Tree, step: int, extra: dict | None = None) -> None:
        """Snapshot ``tree`` to host memory now, write it on a worker thread."""
        self.wait()
        leaves = _flatten(tree, copy=True)      # the snapshot, before returning

        def work():
            try:
                _write(self.directory, leaves, step, self.n_shards, extra)
                self._gc()
            except Exception as e:     # noqa: BLE001 — raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore(self, template: Tree, step: int | None = None) -> tuple[Tree, int]:
        # Drain an in-flight save first, so a restart right after a failure
        # sees the checkpoint just written.  A failed save leaves its error
        # for the next wait(): the latest complete checkpoint is still good.
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        return load_checkpoint(self.directory, template, step)
