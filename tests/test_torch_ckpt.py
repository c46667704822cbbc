"""The port's checkpoints (``repro_torch.ckpt``) against the reference's
protocol.

The port writes its own layout (a JSON manifest and a raw shard; the
reference's msgpack/zstd files are neither read nor written), so it is
held to the reference's behaviour, not its bytes: a bitwise round trip
of a param tree (dicts, lists, 0-dim and int leaves), ``latest_step``
and ``keep_last`` giving the same steps as the reference's ``save`` on
the same sequence, an unpublished ``.tmp`` directory ignored, and a
corrupted shard failing its checksum.
"""

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.models import sar_cnn
from repro_torch.utils.trees import leaves


def _tree():
    params = sar_cnn.init_sar_cnn(torch.Generator().manual_seed(1),
                                  sar_cnn.SarCnnConfig(channels=(4, 8, 8)))
    return {"params": params,
            "history": {"ce": torch.linspace(0.7, 0.1, 5)},
            "count": torch.tensor(7, dtype=torch.int32),
            "codes": np.arange(6, dtype=np.int64).reshape(2, 3)}


def test_round_trip_is_bitwise(tmp_path):
    tree = _tree()
    path = tckpt.save(tmp_path, 12, tree)
    assert path.name == "step_0000000012"
    back, step = tckpt.restore(tmp_path)
    assert step == 12
    assert back["params"]["convs"][2]["w"].shape == (8, 8, 3, 3)
    assert isinstance(back["params"]["convs"], list)
    want, got = leaves(tree), leaves(back)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a = a.numpy() if torch.is_tensor(a) else a
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_latest_step_and_keep_last_follow_the_reference(tmp_path):
    tree = {"w": np.ones((2, 2), np.float32)}
    assert tckpt.latest_step(tmp_path / "t") is None
    assert jckpt.latest_step(tmp_path / "j") is None
    for step in (1, 5, 3, 10, 7):
        tckpt.save(tmp_path / "t", step, tree, keep_last=2)
        jckpt.save(tmp_path / "j", step, tree, keep_last=2)
        assert (tckpt.latest_step(tmp_path / "t")
                == jckpt.latest_step(tmp_path / "j"))
        assert (sorted(p.name for p in (tmp_path / "t").iterdir())
                == sorted(p.name for p in (tmp_path / "j").iterdir()))
    (tmp_path / "t" / "step_0000000099.tmp").mkdir()  # never published
    assert tckpt.latest_step(tmp_path / "t") == 10
    _, step = tckpt.restore(tmp_path / "t", step=7)
    assert step == 7
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "empty")


def test_corrupted_shard_fails_its_checksum(tmp_path):
    path = tckpt.save(tmp_path, 3, _tree())
    shard = path / "shard_0.bin"
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    shard.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        tckpt.restore(tmp_path)
    shard.write_bytes(bytes(raw[:-4]))                 # truncated
    with pytest.raises(IOError, match="checksum"):
        tckpt.restore(tmp_path)
