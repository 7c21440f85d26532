"""Object serialization + mmap sharing.

Equivalent of mem_share.h's obj_desc_t machinery (mem_dump_obj_file
mem_share.h:1126, mem_load_obj_file :1321, mem_share_obj :1394,
mem_find_obj_file :1485): dump a graph of named arrays to one file, load it
back zero-copy via mmap, and register shared objects by name so other
processes can attach. The declarative C descriptor tree becomes a flat
header table (JSON) of named NumPy arrays + scalar metadata.
"""
from __future__ import annotations

import json
import os
import struct
import tempfile
from typing import Dict, Union

import numpy as np

MAGIC = b"BSATOBJ1"
# the registry of shared objects lives under the process's temporary
# directory unless BSA_OBJ_REGISTRY names one
_REG_DIR = os.environ.get(
    "BSA_OBJ_REGISTRY",
    os.path.join(tempfile.gettempdir(), "bsalign_tpu_torch.objs"))

Payload = Dict[str, Union[np.ndarray, int, float, str, bytes]]


def dump_obj_file(obj: Payload, path: str) -> int:
    """Serialize named arrays/scalars; returns total bytes written."""
    arrays = {}
    meta = {}
    for k, v in obj.items():
        if isinstance(v, np.ndarray):
            arrays[k] = np.ascontiguousarray(v)
        elif isinstance(v, bytes):
            arrays[k] = np.frombuffer(v, np.uint8)
            meta.setdefault("__bytes__", []).append(k)
        else:
            meta[k] = v
    table = []
    off = 0
    for k, a in arrays.items():
        off = (off + 63) & ~63          # 64B alignment like aligned_malloc
        table.append({"name": k, "dtype": str(a.dtype),
                      "shape": list(a.shape), "offset": off})
        off += a.nbytes
    head = json.dumps({"meta": meta, "table": table}).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        base = f.tell()
        pad = (-base) % 64
        f.write(b"\0" * pad)
        base += pad
        for ent, a in zip(table, arrays.values()):
            cur = f.tell() - base
            f.write(b"\0" * (ent["offset"] - cur))
            f.write(a.tobytes())
        return f.tell()


def load_obj_file(path: str, mmap: bool = True) -> Payload:
    """Load a dumped object; arrays are zero-copy memory-mapped views when
    mmap=True (mem_load_obj_file's mmap semantics)."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path}: not a bsalign object file")
        (hlen,) = struct.unpack("<Q", f.read(8))
        head = json.loads(f.read(hlen))
        base = f.tell()
        base += (-base) % 64
    out: Payload = dict(head["meta"])
    byte_keys = set(out.pop("__bytes__", []))
    mm = np.memmap(path, np.uint8, mode="r") if mmap else None
    raw = None if mmap else open(path, "rb").read()
    for ent in head["table"]:
        dt = np.dtype(ent["dtype"])
        shape = tuple(ent["shape"])
        n = int(np.prod(shape)) * dt.itemsize if shape else dt.itemsize
        lo = base + ent["offset"]
        if mmap:
            arr = mm[lo:lo + n].view(dt).reshape(shape)
        else:
            arr = np.frombuffer(raw[lo:lo + n], dt).reshape(shape)
        out[ent["name"]] = arr.tobytes() if ent["name"] in byte_keys else arr
    return out


def share_obj(name: str, obj: Payload) -> str:
    """Publish an object under a global name (mem_share_obj); other
    processes attach with find_obj_file/attach_obj."""
    os.makedirs(_REG_DIR, exist_ok=True)
    path = os.path.join(_REG_DIR, name + ".obj")
    tmp = path + f".tmp.{os.getpid()}"
    dump_obj_file(obj, tmp)
    os.replace(tmp, path)               # atomic publish (the lock registry)
    return path


def find_obj_file(name: str) -> str | None:
    """mem_find_obj_file: path of a published object, else None."""
    path = os.path.join(_REG_DIR, name + ".obj")
    return path if os.path.exists(path) else None


def attach_obj(name: str) -> Payload | None:
    path = find_obj_file(name)
    return load_obj_file(path, mmap=True) if path else None


def unshare_obj(name: str) -> bool:
    path = find_obj_file(name)
    if path:
        os.unlink(path)
        return True
    return False
