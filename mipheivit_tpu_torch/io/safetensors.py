"""The safetensors format with only ``json``, ``struct`` and numpy.

A file is an 8-byte little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (plus an
optional ``__metadata__`` entry), then the raw little-endian buffers, offsets
counted from the end of the header. Tensors come back as CPU torch tensors;
bf16, which numpy lacks, is read through its 16-bit pattern.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

_NUMPY = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_NAMES = {np.dtype(v): k for k, v in _NUMPY.items()}


def load_file(path) -> Dict[str, torch.Tensor]:
    """All tensors of a safetensors file. The file is memory-mapped
    copy-on-write, so pages are read as tensors are used."""
    raw = np.memmap(path, dtype=np.uint8, mode="c")
    (n,) = struct.unpack("<Q", raw[:8].tobytes())
    header = json.loads(raw[8:8 + n].tobytes())
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        buf = raw[base + begin:base + end]
        dtype = info["dtype"]
        np_dtype = np.int16 if dtype == "BF16" else _NUMPY.get(dtype)
        if np_dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {dtype}")
        if (base + begin) % np.dtype(np_dtype).itemsize:
            buf = buf.copy()                      # unaligned: views need alignment
        arr = buf.view(np_dtype).reshape(info["shape"])
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if dtype == "BF16" else t
    return out


def _to_numpy(value):
    """(safetensors dtype name, C-contiguous little-endian numpy array)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().contiguous()
        if value.dtype == torch.bfloat16:
            return "BF16", value.view(torch.int16).numpy()
        value = value.numpy()
    arr = np.ascontiguousarray(value)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    if arr.dtype not in _NAMES:
        raise ValueError(f"dtype {arr.dtype} has no safetensors name")
    return _NAMES[arr.dtype], arr


def save_file(tensors: Mapping[str, object], path) -> None:
    """Write numpy arrays or torch tensors. Buffers are laid out widest
    element first, so each stays aligned to its element size."""
    items = {name: _to_numpy(v) for name, v in tensors.items()}
    order = sorted(items, key=lambda k: (-items[k][1].dtype.itemsize, k))
    header, offset = {}, 0
    for name in order:
        dtype, arr = items[name]
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)               # data starts 8-byte aligned
    with open(Path(path), "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            f.write(items[name][1].tobytes())
