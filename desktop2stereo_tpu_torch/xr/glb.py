"""Minimal glTF 2.0 / GLB environment parser (numpy only).

Port of `desktop2stereo_tpu/xr/glb.py`, copied: host numpy.

Loads the XR environment scenes the reference renders around the virtual
screen (reference xr_viewer/render.py:21-230 `_read_glb_chunks` /
`_get_accessor` / node matrices, environment.py:55-1800): mesh primitives
with world transforms, base-color materials, and KHR_lights_punctual.
No GPU types — output is plain numpy, ready for any client renderer.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_GLB_MAGIC = 0x46546C67
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_LANES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT2": 4, "MAT3": 9, "MAT4": 16}


@dataclass
class Primitive:
    positions: np.ndarray                 # [N, 3] f32, world space
    normals: Optional[np.ndarray]         # [N, 3] f32, world space
    uvs: Optional[np.ndarray]             # [N, 2] f32
    indices: Optional[np.ndarray]         # [M] u32
    base_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    node_name: str = ""


@dataclass
class Light:
    """KHR_lights_punctual light placed by its node's world matrix."""
    kind: str                             # "directional" | "point" | "spot"
    color: Tuple[float, float, float]
    intensity: float
    position: Tuple[float, float, float]
    direction: Tuple[float, float, float]


@dataclass
class Scene:
    primitives: List[Primitive] = field(default_factory=list)
    lights: List[Light] = field(default_factory=list)

    @property
    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        pts = np.concatenate([p.positions for p in self.primitives], axis=0)
        return pts.min(axis=0), pts.max(axis=0)


def _read_chunks(data: bytes) -> Tuple[dict, bytes]:
    magic, version, total = struct.unpack_from("<III", data, 0)
    if magic != _GLB_MAGIC:
        raise ValueError("not a GLB file (bad magic)")
    if version != 2:
        raise ValueError(f"unsupported glTF version {version}")
    gltf: Optional[dict] = None
    binary = b""
    off = 12
    while off + 8 <= min(total, len(data)):
        length, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8:off + 8 + length]
        if ctype == _CHUNK_JSON:
            gltf = json.loads(chunk.decode("utf-8"))
        elif ctype == _CHUNK_BIN:
            binary = chunk
        off += 8 + length + (-length % 4 if length % 4 else 0)
    if gltf is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf, binary


def _accessor(gltf: dict, binary: bytes, index: int) -> np.ndarray:
    acc = gltf["accessors"][index]
    lanes = _TYPE_LANES[acc["type"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]]).newbyteorder("<")
    count = acc["count"]
    if "bufferView" not in acc:
        # glTF 2.0: an accessor without a bufferView is zero-filled (sparse
        # base case) — never read view 0's unrelated bytes.
        out = np.zeros((count, lanes), dtype)
        return out[:, 0] if lanes == 1 else out
    view = gltf["bufferViews"][acc["bufferView"]]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    item = dtype.itemsize * lanes
    if stride and stride != item:
        rows = [
            np.frombuffer(binary, dtype, lanes, start + i * stride)
            for i in range(count)
        ]
        out = np.stack(rows)
    else:
        out = np.frombuffer(binary, dtype, count * lanes, start).reshape(count, lanes)
    return out[:, 0] if lanes == 1 else out


def _node_local(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], np.float32).reshape(4, 4).T  # column-major
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = np.diag(list(node["scale"]) + [1.0]).astype(np.float32) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1],
        ], np.float32)
        m = r @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _walk(gltf: dict, index: int, parent: np.ndarray, out: Dict[int, np.ndarray]):
    node = gltf["nodes"][index]
    world = parent @ _node_local(node)
    out[index] = world
    for child in node.get("children", ()):
        _walk(gltf, child, world, out)


def load_glb(path_or_bytes) -> Scene:
    """Parse a .glb into world-space primitives + punctual lights."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    gltf, binary = _read_chunks(data)

    worlds: Dict[int, np.ndarray] = {}
    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes") or [{}]
    roots = scenes[min(scene_idx, len(scenes) - 1)].get("nodes", [])
    if not roots and gltf.get("nodes"):
        # tolerate scene-less exports: treat un-parented nodes as roots
        children = {c for n in gltf["nodes"] for c in n.get("children", ())}
        roots = [i for i in range(len(gltf["nodes"])) if i not in children]
    for root in roots:
        _walk(gltf, root, np.eye(4, dtype=np.float32), worlds)

    materials = gltf.get("materials", [])
    lights_def = gltf.get("extensions", {}).get(
        "KHR_lights_punctual", {}).get("lights", [])

    scene = Scene()
    for node_idx, world in worlds.items():
        node = gltf["nodes"][node_idx]
        normal_mat = np.linalg.inv(world[:3, :3]).T if \
            abs(np.linalg.det(world[:3, :3])) > 1e-12 else world[:3, :3]

        light_ref = node.get("extensions", {}).get(
            "KHR_lights_punctual", {}).get("light")
        if light_ref is not None and light_ref < len(lights_def):
            ld = lights_def[light_ref]
            fwd = -world[:3, 2]
            scene.lights.append(Light(
                kind=ld.get("type", "point"),
                color=tuple(ld.get("color", [1.0, 1.0, 1.0])),
                intensity=float(ld.get("intensity", 1.0)),
                position=tuple(world[:3, 3]),
                direction=tuple(fwd / max(np.linalg.norm(fwd), 1e-12)),
            ))

        if "mesh" not in node:
            continue
        mesh = gltf["meshes"][node["mesh"]]
        for prim in mesh.get("primitives", []):
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            pos = _accessor(gltf, binary, attrs["POSITION"]).astype(np.float32)
            pos = pos @ world[:3, :3].T + world[:3, 3]
            nrm = None
            if "NORMAL" in attrs:
                nrm = _accessor(gltf, binary, attrs["NORMAL"]).astype(np.float32)
                nrm = nrm @ normal_mat.T
                nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
            uv = (_accessor(gltf, binary, attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs else None)
            idx = (_accessor(gltf, binary, prim["indices"]).astype(np.uint32)
                   if "indices" in prim else None)
            color = (1.0, 1.0, 1.0, 1.0)
            mat_i = prim.get("material")
            if mat_i is not None and mat_i < len(materials):
                pbr = materials[mat_i].get("pbrMetallicRoughness", {})
                color = tuple(pbr.get("baseColorFactor", [1, 1, 1, 1]))
            scene.primitives.append(Primitive(
                positions=pos, normals=nrm, uvs=uv, indices=idx,
                base_color=color, node_name=node.get("name", "")))
    return scene
