"""The safetensors format, read and written without the `safetensors` package.

A file is an 8-byte little-endian header length N, N bytes of JSON, then the
raw buffer.  The JSON maps each tensor name to {"dtype", "shape",
"data_offsets": [begin, end]} (offsets into the buffer) and may hold a
"__metadata__" map of strings (checked, not returned).  `load_file` returns what
`safetensors.numpy.load_file` returns (the same dtypes, little-endian
arrays); anything it cannot read raises ValueError naming the tensor.

A checkpoint may be sharded: `load_checkpoint` takes the index json
(`model.safetensors.index.json`, its `weight_map` naming the shards) or any
one shard `model-NNNNN-of-NNNNN.safetensors` (its siblings are globbed), as
`desktop2stereo_tpu/models/convert_hf.py:to_numpy_state_dict` does.
`save_file` and `save_sharded` write both layouts (for tests and for
checkpoints made from seeded weights).
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import struct
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# the dtypes safetensors.numpy reads (BF16 and the F8 types it cannot)
DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "U64": np.uint64, "I32": np.int32, "U32": np.uint32,
    "I16": np.int16, "U16": np.uint16, "I8": np.int8, "U8": np.uint8,
    "BOOL": np.bool_, "C64": np.complex64,
}
_NAMES = {np.dtype(t): name for name, t in DTYPES.items()}
_SHARD = re.compile(r"model-\d+-of-\d+\.safetensors$")
INDEX_NAME = "model.safetensors.index.json"


def load_file(path) -> Dict[str, np.ndarray]:
    """One safetensors file → {name: array} in the file's dtypes."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: truncated header ({size} bytes, no length field)")
        (n,) = struct.unpack("<Q", f.read(8))
        if 8 + n > size:
            raise ValueError(f"{path}: truncated header (length {n}, file {size} bytes)")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: malformed header ({e})") from None
        if not isinstance(header, dict):
            raise ValueError(f"{path}: malformed header (not a JSON object)")
        buf = bytearray(size - 8 - n)
        f.readinto(buf)
    meta = header.pop("__metadata__", None) or {}
    if not isinstance(meta, dict) or not all(isinstance(v, str) for v in meta.values()):
        raise ValueError(f"{path}: __metadata__ must map names to strings")
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        try:
            dtype_name, shape = info["dtype"], [int(s) for s in info["shape"]]
            begin, end = (int(o) for o in info["data_offsets"])
        except (TypeError, KeyError, ValueError):
            raise ValueError(f"{path}: tensor {name!r}: malformed entry {info!r}") from None
        if dtype_name not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r}: unknown dtype {dtype_name!r} "
                             f"(readable: {', '.join(DTYPES)})")
        dtype = np.dtype(DTYPES[dtype_name]).newbyteorder("<")
        if not 0 <= begin <= end <= len(buf) or min(shape, default=0) < 0:
            raise ValueError(f"{path}: tensor {name!r}: offsets [{begin}, {end}] outside "
                             f"the {len(buf)}-byte buffer")
        if end - begin != math.prod(shape) * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r}: {end - begin} bytes for shape "
                             f"{shape} of {dtype_name}")
        out[name] = np.frombuffer(buf, dtype, math.prod(shape), begin).reshape(shape)
    return out


def _checkpoint_files(path) -> Tuple[str, ...]:
    """The files of a checkpoint: the shards an index json names, every
    `model-*-of-*.safetensors` beside a shard, or the file itself."""
    path = os.fspath(path)
    base, d = os.path.basename(path), os.path.dirname(path)
    if base.endswith(".index.json"):
        with open(path) as f:
            weight_map = json.load(f).get("weight_map", {})
        return tuple(os.path.join(d, s) for s in sorted(set(weight_map.values())))
    if _SHARD.match(base):
        return tuple(sorted(glob.glob(os.path.join(d or ".", "model-*-of-*.safetensors"))))
    return (path,)


def load_checkpoint(path) -> Dict[str, np.ndarray]:
    """A single-file or sharded checkpoint, merged, in the files' dtypes."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {os.fspath(path)!r} does not exist")
    out: Dict[str, np.ndarray] = {}
    for f in _checkpoint_files(path):
        out.update(load_file(f))
    return out


def load_tensors(path, device: torch.device | str) -> Dict[str, torch.Tensor]:
    """A checkpoint's tensors, in their dtypes, on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in load_checkpoint(path).items()}


def save_file(tensors: Mapping[str, np.ndarray], path) -> None:
    """Write {name: array} as one safetensors file (names sorted, the header
    padded with spaces to a multiple of 8 bytes, as the reference writer
    does)."""
    header: Dict[str, object] = {}
    arrays, offset = [], 0
    for name in sorted(tensors):
        a = np.ascontiguousarray(tensors[name])
        dtype_name = _NAMES.get(a.dtype.newbyteorder("="))
        if dtype_name is None:
            raise ValueError(f"tensor {name!r}: dtype {a.dtype} has no safetensors name")
        a = a.astype(a.dtype.newbyteorder("<"), copy=False)
        header[name] = {"dtype": dtype_name, "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        arrays.append(a)
        offset += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for a in arrays:
            f.write(a.tobytes())


def save_sharded(tensors: Mapping[str, np.ndarray], directory, shards: int) -> str:
    """Write `shards` files `model-0000i-of-0000N.safetensors` (names sorted,
    split evenly by count) and their index json; returns the index's path."""
    names = sorted(tensors)
    per = -(-len(names) // shards)
    weight_map: Dict[str, str] = {}
    for i in range(shards):
        part = names[i * per:(i + 1) * per]
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        save_file({k: tensors[k] for k in part}, os.path.join(directory, fname))
        weight_map.update({k: fname for k in part})
    total = sum(np.asarray(tensors[k]).nbytes for k in names)
    index = os.path.join(directory, INDEX_NAME)
    with open(index, "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=1)
    return index
