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
steps stay.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path

import numpy as np

from repro_torch.bridge import to_numpy
from repro_torch.utils.trees import flatten_dict, unflatten_dict

_MANIFEST = "manifest.json"
_SHARD = "shard_0.bin"


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
        for path, leaf in sorted(flatten_dict(to_numpy(tree)).items()):
            arr = np.asarray(leaf)
            buf = arr.tobytes()                         # C order
            manifest["leaves"][path] = {
                "shape": list(arr.shape), "dtype": arr.dtype.str,
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
    """-> (tree of numpy arrays, step); the newest step unless ``step``.
    Raises ``IOError`` where a leaf's bytes fail their crc32."""
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
        flat[path] = np.frombuffer(buf, dtype=np.dtype(meta["dtype"])
                                   ).reshape(meta["shape"]).copy()
    return unflatten_dict(flat), manifest["step"]
