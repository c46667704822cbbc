"""Checkpoints: atomic, checksummed param trees (port of ``save``,
``latest_step`` and ``restore`` of ``repro/ckpt/checkpoint.py``).

Layout, one directory per step, ``step_<10 digits>/``:
  * ``manifest.json``: the step and, per leaf path ('convs/#0/w'), its
    shape, dtype, crc32 and byte range in the shard;
  * ``shard_0.bin``: the leaves' raw bytes, concatenated.

This is the port's own layout, not the reference's (msgpack manifest,
zstd shard): the port neither reads nor writes that format.  Safety as
the reference's: written to ``<step>.tmp`` and published by
``os.rename`` (a crash mid-write never corrupts the latest checkpoint);
every leaf's crc32 is verified on restore; ``keep_last`` bounds how many
steps stay.  numpy has no bfloat16: a bfloat16 tensor is stored as its
16-bit patterns under the dtype tag ``bfloat16`` and restored as a
``torch.bfloat16`` tensor (every other leaf comes back as numpy).

``AsyncCheckpointer`` overlaps the write with training: ``submit``
copies the tree to the host (the only part that must see a consistent
state), then a daemon thread writes it; ``wait`` joins the write in
flight and re-raises its error.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch.utils.trees import flatten_dict, tree_map, unflatten_dict

_MANIFEST = "manifest.json"
_SHARD = "shard_0.bin"
_BF16 = "bfloat16"


def _leaf_array(leaf) -> tuple[np.ndarray, str]:
    """-> (a numpy array holding the leaf's bytes, its dtype tag)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, arr.dtype.str


def _leaf_from(buf: bytes, meta: dict):
    if meta["dtype"] == _BF16:
        bits = np.frombuffer(buf, np.int16).reshape(meta["shape"]).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(meta["dtype"])).reshape(
        meta["shape"]).copy()


def _step_dir(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"step_{step:010d}"


def save(ckpt_dir: str | Path, step: int, tree, keep_last: int = 3) -> Path:
    """Write ``tree`` (tensors or numpy arrays in dicts and lists) as
    step ``step``; returns the published directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final.with_name(final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": {}}
    offset = 0
    with open(tmp / _SHARD, "wb") as f:
        for path, leaf in sorted(flatten_dict(tree).items()):
            arr, dtype = _leaf_array(leaf)
            buf = arr.tobytes()                         # C order
            manifest["leaves"][path] = {
                "shape": list(arr.shape), "dtype": dtype,
                "crc32": zlib.crc32(buf), "offset": offset,
                "nbytes": len(buf)}
            f.write(buf)
            offset += len(buf)
    (tmp / _MANIFEST).write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                                # atomic publish
    _gc(ckpt_dir, keep_last)
    return final


def _steps(ckpt_dir: Path) -> list[int]:
    if not ckpt_dir.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
                  if p.is_dir() and p.name.startswith("step_")
                  and not p.name.endswith(".tmp"))


def _gc(ckpt_dir: Path, keep_last: int) -> None:
    for step in _steps(ckpt_dir)[:-keep_last]:
        shutil.rmtree(_step_dir(ckpt_dir, step))


def latest_step(ckpt_dir: str | Path) -> int | None:
    """The newest published step, or None."""
    steps = _steps(Path(ckpt_dir))
    return steps[-1] if steps else None


def restore(ckpt_dir: str | Path, step: int | None = None):
    """-> (tree of numpy arrays, bfloat16 leaves as torch tensors,
    step); the newest step unless ``step``.  Raises ``IOError`` where a
    leaf's bytes fail their crc32."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    manifest = json.loads((d / _MANIFEST).read_text())
    raw = (d / _SHARD).read_bytes()
    flat = {}
    for path, meta in manifest["leaves"].items():
        buf = raw[meta["offset"]:meta["offset"] + meta["nbytes"]]
        if len(buf) != meta["nbytes"] or zlib.crc32(buf) != meta["crc32"]:
            raise IOError(f"checksum mismatch for {path} in {d}")
        flat[path] = _leaf_from(buf, meta)
    return unflatten_dict(flat), manifest["step"]


class AsyncCheckpointer:
    """Checkpoints written on a background thread (the reference's
    ``AsyncCheckpointer``, on this module's ``save``).

    ``submit`` waits for the previous write, copies the tree's tensors
    to the host (a device-to-host copy on the card: the train loop
    stalls for it alone), then hands the write to a daemon thread.
    ``wait`` joins the write in flight and re-raises its error; call it
    before exit and before restoring."""

    def __init__(self, ckpt_dir: str | Path, keep_last: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self.error: BaseException | None = None

    def submit(self, step: int, tree) -> None:
        self.wait()
        host_tree = tree_map(
            lambda x: (x.detach().to("cpu", copy=True)
                       if isinstance(x, torch.Tensor) else np.array(x)),
            tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, self.keep_last)
            except BaseException as e:  # noqa: BLE001 — re-raised by wait
                self.error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err
