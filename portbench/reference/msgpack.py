"""Reader of Flax msgpack checkpoints (numpy only), for the weights under
``portbench/weights/``.

A checkpoint is one msgpack document: nested string-keyed maps whose
array leaves are extension objects, type 1 an ndarray and type 3 a numpy
scalar, each with the payload ``[shape, dtype_name, C-order bytes]``.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


class _Unpacker:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def unpack(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.unpack() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.uint(1 << (b - 0xC7))
            return self.ext(self.sint(1), n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:
            code = self.sint(1)
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.take(self.uint(1 << (b - 0xD9))).decode()
        if b in (0xDC, 0xDD):
            n = self.uint(2 if b == 0xDC else 4)
            return [self.unpack() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.unpack()
            out[key] = self.unpack()
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code in (1, 3):
            shape, dtype_name, buffer = unpackb(payload)
            arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(
                shape, order="C")
            return arr if code == 1 else arr[()]
        raise ValueError(f"unknown msgpack extension type {code}")


def unpackb(data: bytes):
    unpacker = _Unpacker(bytes(data))
    out = unpacker.unpack()
    if unpacker.pos != len(unpacker.data):
        raise ValueError("trailing bytes after msgpack document")
    return out


def load_checkpoint(path) -> dict:
    return unpackb(Path(path).read_bytes())


def mlp_weights(payload: dict) -> dict:
    """The NeuralFSAI layers of a payload as float64 numpy: per layer
    ``(kernel (in, out), bias)`` and ``q_coeffs`` (the delta over e0),
    with the payload's width, hidden size, degree and pattern power."""
    tree = payload["params"]["params"]
    out = {name: (np.asarray(tree[name]["kernel"], np.float64),
                  np.asarray(tree[name]["bias"], np.float64))
           for name in ("dense0", "dense1", "alpha", "beta")}
    out["q_coeffs"] = np.asarray(tree["q_coeffs"], np.float64)
    for key in ("width", "hidden", "poly_degree", "power"):
        out[key] = int(payload[key])
    return out
