"""Safetensors reading and writing for the port
(counterpart of exllamav3_tpu/loader/safetensors.py).

The reader parses each file's header, maps the file, and returns torch
tensors that view the mapping (copy-on-write, so no tensor ever writes back
to the file). BF16 is read as torch.bfloat16 directly. The writer takes
numpy arrays (or CPU tensors) and produces the same bytes as the JAX
package's `save_file`. The fp8, MXFP4 and overlay readers are not ported yet.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from dataclasses import dataclass

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}

_DTYPE_NAMES = {
    np.dtype(np.float64): "F64",
    np.dtype(np.float32): "F32",
    np.dtype(np.float16): "F16",
    np.dtype(np.int64): "I64",
    np.dtype(np.int32): "I32",
    np.dtype(np.int16): "I16",
    np.dtype(np.int8): "I8",
    np.dtype(np.uint8): "U8",
    np.dtype(np.uint16): "U16",
    np.dtype(np.uint32): "U32",
    np.dtype(np.bool_): "BOOL",
}


def f32_to_bf16_u16(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 bit pattern (uint16)."""
    u = x.astype(np.float32).view(np.uint32)
    rounding = ((u >> 16) & 1) + 0x7FFF
    return ((u + rounding) >> 16).astype(np.uint16)


@dataclass
class TensorInfo:
    file: str
    dtype_str: str
    shape: tuple
    start: int  # absolute byte offset in the file
    end: int

    @property
    def nbytes(self) -> int:
        return self.end - self.start


class SafetensorsCollection:
    """Read-only view over all *.safetensors files in a directory."""

    def __init__(self, directory: str):
        self.directory = directory
        self.tensor_map: dict[str, TensorInfo] = {}
        self.metadata: dict = {}
        self._mmaps: dict[str, mmap.mmap] = {}
        for fn in sorted(f for f in os.listdir(directory) if f.endswith(".safetensors")):
            self._index_file(os.path.join(directory, fn))

    def _index_file(self, path: str):
        with open(path, "rb") as f:
            (header_len,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(header_len))
        base = 8 + header_len
        for key, info in header.items():
            if key == "__metadata__":
                self.metadata.update(info)
                continue
            self.tensor_map[key] = TensorInfo(
                file=path, dtype_str=info["dtype"], shape=tuple(info["shape"]),
                start=base + info["data_offsets"][0],
                end=base + info["data_offsets"][1])

    def _get_mmap(self, path: str) -> mmap.mmap:
        if path not in self._mmaps:
            with open(path, "rb") as f:
                self._mmaps[path] = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        return self._mmaps[path]

    def keys(self):
        return self.tensor_map.keys()

    def has_tensor(self, key: str) -> bool:
        return key in self.tensor_map

    def has_tensor_group(self, key: str, subkeys: list) -> bool:
        """subkeys: str or list of alternative str, all of which must exist."""
        for sk in subkeys:
            alts = sk if isinstance(sk, (list, tuple)) else [sk]
            if not any(f"{key}.{a}" in self.tensor_map for a in alts):
                return False
        return True

    def get_shape(self, key: str) -> tuple:
        return self.tensor_map[key].shape

    def get_dtype_str(self, key: str) -> str:
        return self.tensor_map[key].dtype_str

    def get_tensor(self, key: str, optional: bool = False) -> torch.Tensor | None:
        """The tensor as a CPU torch tensor in its stored dtype."""
        info = self.tensor_map.get(key)
        if info is None:
            if optional:
                return None
            raise KeyError(f"tensor not found: {key}")
        dtype = _DTYPES.get(info.dtype_str)
        if dtype is None:
            raise ValueError(f"unsupported dtype {info.dtype_str} for {key}")
        if info.nbytes == 0:
            return torch.empty(info.shape, dtype=dtype)
        mm = self._get_mmap(info.file)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if info.start % itemsize:
            buf = bytearray(mm[info.start:info.end])
            t = torch.frombuffer(buf, dtype=dtype)
        else:
            t = torch.frombuffer(mm, dtype=dtype, count=info.nbytes // itemsize,
                                 offset=info.start)
        return t.reshape(info.shape)


def save_file(tensors: dict, path: str, metadata: dict | None = None, bf16_keys=()):
    """Write one .safetensors file. Values are numpy arrays or CPU tensors;
    entries named in bf16_keys hold uint16 bf16 bit patterns and are written
    as BF16 (a torch.bfloat16 tensor is written as BF16 on its own). The
    file appears atomically."""
    header = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    blobs = []
    for key, arr in tensors.items():
        dt = None
        if isinstance(arr, torch.Tensor):
            if arr.dtype == torch.bfloat16:
                arr, dt = arr.contiguous().view(torch.int16).numpy().view(np.uint16), "BF16"
            else:
                arr = arr.contiguous().numpy()
        arr = np.ascontiguousarray(arr)
        if key in bf16_keys:
            if arr.dtype != np.uint16:
                raise ValueError(f"{key}: bf16 entries must hold uint16 bit patterns")
            dt = "BF16"
        if dt is None:
            dt = _DTYPE_NAMES.get(arr.dtype)
            if dt is None:
                raise ValueError(f"unsupported dtype {arr.dtype} for {key}")
        header[key] = {"dtype": dt, "shape": list(arr.shape),
                       "data_offsets": [offset, offset + arr.nbytes]}
        blobs.append(arr)
        offset += arr.nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * ((-(8 + len(hjson))) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(memoryview(b).cast("B"))
    os.replace(tmp, path)
