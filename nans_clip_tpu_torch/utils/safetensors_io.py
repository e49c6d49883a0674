"""Read and write the ``.safetensors`` format with torch alone.

The HF ``save_pretrained`` snapshots that ``utils/hf_interop.py`` reads and
writes hold their weights in ``model.safetensors``; the JAX package goes
through the ``safetensors`` package for them, which the port does not need.
A file is:

* 8 bytes: the header's length N, little-endian u64;
* N bytes: a JSON object, ``{"__metadata__": {str: str}, name: {"dtype":
  "F32", "shape": [...], "data_offsets": [begin, end]}, ...}``, padded with
  spaces to a multiple of 8 bytes;
* the tensors' raw little-endian bytes, ``data_offsets`` counted from the
  end of the header.

:func:`save_file` lays a file out as the ``safetensors`` package (0.8)
does, byte for byte: the tensors sorted by dtype (widest first, in the
package's own order) then by name, the JSON without spaces, the metadata
first (the package orders two or more metadata keys by a hash map, this
module by insertion).
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import numpy as np
import torch

# the package's dtype order, first written first
_DTYPES = (("I64", torch.int64), ("F64", torch.float64), ("F32", torch.float32),
           ("I32", torch.int32), ("BF16", torch.bfloat16), ("F16", torch.float16),
           ("I16", torch.int16), ("I8", torch.int8), ("U8", torch.uint8),
           ("BOOL", torch.bool))
_NAME = {dt: name for name, dt in _DTYPES}
_TORCH = {name: dt for name, dt in _DTYPES}
_RANK = {name: i for i, (name, _) in enumerate(_DTYPES)}


def _tensor(value) -> torch.Tensor:
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return value.detach().to("cpu").contiguous()


def save_file(tensors: Dict[str, object], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays) to ``path``."""
    items = []
    for name, value in tensors.items():
        t = _tensor(value)
        if t.dtype not in _NAME:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here")
        items.append((name, t))
    items.sort(key=lambda kv: (_RANK[_NAME[kv[1].dtype]], kv[0]))
    header: dict = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset, blobs = 0, []
    for name, t in items:
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAME[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for blob in blobs:
            f.write(blob)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a ``.safetensors`` file, on the CPU, in the
    dtypes it stores."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n).decode("utf-8"))
        data = f.read()
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _TORCH:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(_TORCH)}")
        begin, end = info["data_offsets"]
        dtype = _TORCH[info["dtype"]]
        buf = bytearray(data[begin:end])
        flat = (torch.frombuffer(buf, dtype=torch.uint8).view(dtype) if buf
                else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out
