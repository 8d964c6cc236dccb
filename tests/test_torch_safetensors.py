"""The port's safetensors reader and writer (`models/safetensors_io.py`)
against the `safetensors` package: the same arrays as
`safetensors.numpy.load_file` on files written by
`safetensors.torch.save_file`, the port's files read back by the package,
both sharded layouts merged, and ValueError naming the tensor on a file it
cannot read.
"""

import json
import struct

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy
from safetensors.torch import save_file as st_save_torch

from desktop2stereo_tpu_torch.models import safetensors_io as io
from desktop2stereo_tpu_torch.models.convert_hf import to_numpy_state_dict
from torch_threads import one_torch_thread  # noqa: F401


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"blocks.0.attn.qkv.weight": torch.randn(12, 4, generator=g),
            "blocks.0.attn.qkv.bias": torch.randn(12, generator=g).half(),
            "pos_embed": torch.randn(1, 5, 4, generator=g, dtype=torch.float64),
            "steps": torch.arange(-3, 4, dtype=torch.int32),
            "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3),
            "mask": torch.tensor([True, False, True]),
            "bytes": torch.arange(250, 256, dtype=torch.uint8),
            "q": torch.randint(-128, 128, (3, 3), generator=g, dtype=torch.int8),
            "empty": torch.zeros(0, 4)}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reader_equals_safetensors_numpy(tmp_path):
    path = tmp_path / "model.safetensors"
    st_save_torch(_tensors(), str(path), metadata={"format": "pt", "note": "seeded"})
    _assert_same(io.load_file(path), st_load_numpy(str(path)))


def test_writer_round_trips_and_the_package_reads_it(tmp_path):
    want = {k: v.numpy() for k, v in _tensors(1).items()}
    path = tmp_path / "mine.safetensors"
    io.save_file(want, path)
    _assert_same(io.load_file(path), want)
    _assert_same(st_load_numpy(str(path)), want)
    # the header is padded to 8 bytes, as the package writes it
    assert struct.unpack("<Q", path.read_bytes()[:8])[0] % 8 == 0


def test_big_endian_arrays_are_written_little_endian(tmp_path):
    a = np.arange(6, dtype=">f4").reshape(2, 3)
    io.save_file({"a": a}, tmp_path / "be.safetensors")
    got = st_load_numpy(str(tmp_path / "be.safetensors"))["a"]
    np.testing.assert_array_equal(got, a.astype("<f4"))


@pytest.mark.parametrize("layout", ["index", "shard"])
def test_sharded_checkpoint_loads_the_merged_set(tmp_path, layout):
    want = {k: v.numpy() for k, v in _tensors(2).items()}
    index = io.save_sharded(want, tmp_path, shards=3)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "model-00001-of-00003.safetensors", "model-00002-of-00003.safetensors",
        "model-00003-of-00003.safetensors", "model.safetensors.index.json"]
    weight_map = json.loads((tmp_path / "model.safetensors.index.json").read_text())["weight_map"]
    assert set(weight_map) == set(want)
    path = index if layout == "index" else tmp_path / "model-00002-of-00003.safetensors"
    _assert_same(io.load_checkpoint(path), want)
    # to_numpy_state_dict: the merged set in f32, as the JAX converter reads it
    f32 = to_numpy_state_dict(str(path))
    assert all(v.dtype == np.float32 for v in f32.values())
    np.testing.assert_array_equal(f32["steps"], want["steps"].astype(np.float32))


def test_load_tensors_keeps_dtypes(tmp_path):
    st_save_torch(_tensors(3), str(tmp_path / "t.safetensors"))
    got = io.load_tensors(tmp_path / "t.safetensors", "cpu")
    for k, v in _tensors(3).items():
        assert torch.equal(got[k], v), k


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="nope.safetensors"):
        io.load_checkpoint(tmp_path / "nope.safetensors")


def _raw(header, buffer=b""):
    raw = json.dumps(header).encode()
    return struct.pack("<Q", len(raw)) + raw + buffer


@pytest.mark.parametrize("content,match", [
    (b"\x10\x00", "truncated header"),
    (struct.pack("<Q", 4096) + b'{"a": ', "truncated header"),
    (struct.pack("<Q", 5) + b'{"a":', "malformed header"),
    (_raw({"w": {"dtype": "F32", "shape": [2, 2], "data_offsets": [0, 16]}}, b"\0" * 8),
     "'w'.*outside"),
    (_raw({"w": {"dtype": "F32", "shape": [2, 2], "data_offsets": [8, 4]}}, b"\0" * 16),
     "'w'.*outside"),
    (_raw({"w": {"dtype": "F32", "shape": [3], "data_offsets": [0, 16]}}, b"\0" * 16),
     "'w'.*16 bytes for shape"),
    (_raw({"w": {"dtype": "BF16", "shape": [2], "data_offsets": [0, 4]}}, b"\0" * 4),
     "'w'.*unknown dtype 'BF16'"),
    (_raw({"w": {"dtype": "F32", "shape": [1]}}, b"\0" * 4), "'w'.*malformed"),
    (_raw({"__metadata__": {"n": 1}}), "__metadata__"),
], ids=["short", "truncated", "malformed", "offset-past-end", "offsets-reversed",
        "size-mismatch", "bf16", "no-offsets", "metadata-not-strings"])
def test_unreadable_files_raise_value_error(tmp_path, content, match):
    path = tmp_path / "bad.safetensors"
    path.write_bytes(content)
    with pytest.raises(ValueError, match=match):
        io.load_file(path)


def test_writer_refuses_a_dtype_without_a_name(tmp_path):
    with pytest.raises(ValueError, match="'s'"):
        io.save_file({"s": np.array(["x"])}, tmp_path / "s.safetensors")
