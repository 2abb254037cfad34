"""Reader and writer of Flax msgpack checkpoints, with no msgpack or flax
import.

Counterpart of ``deeppreconditioning_tpu/train/trainer.py::load_checkpoint``
(``flax.serialization.msgpack_restore``) and of the trainer's checkpoint
writes (``flax.serialization.to_bytes``).  A checkpoint is one msgpack
document: nested string-keyed maps whose array leaves are msgpack
extension objects.  Flax writes an ndarray as extension type 1, whose
payload is itself a msgpack array ``[shape, dtype_name, C-order bytes]``,
and a numpy scalar as extension type 3 with the same payload (restored as
the 0-d array's scalar).  Flax's other extension (type 2, Python complex)
and its ``__msgpack_chunked_array__`` maps (arrays above 1 GiB) do not
occur in these checkpoints: the first raises, the second is not joined.

``packb`` writes what ``flax.serialization.to_bytes`` writes for such a
tree: maps in their key order, strings as str, ints in their shortest
form, Python floats as float64, ndarrays as extension type 1 and numpy
scalars as type 3, their payload bytes as bin.  ``adam_state_to_jax`` / ``adam_state_from_jax``
map a ``torch.optim.Adam`` state to and from optax's ``adam`` state as
Flax serializes it: ``{"0": {"count", "mu", "nu"}, "1": {}}``, or
``"1": {"count"}`` when the rate follows a schedule.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Unpacker:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _int(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big", signed=True)

    def unpack(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode()
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self._take(self._uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self._uint(1 << (b - 0xC7))
            return self._ext(self._int(1), n)
        if b == 0xCA:
            return struct.unpack(">f", self._take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self._take(8))[0]
        if 0xCC <= b <= 0xCF:  # uint 8/16/32/64
            return self._uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:  # int 8/16/32/64
            return self._int(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self._int(1)
            return self._ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._take(self._uint(1 << (b - 0xD9))).decode()
        if b in (0xDC, 0xDD):  # array 16/32
            return self._array(self._uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):  # map 16/32
            return self._map(self._uint(2 if b == 0xDE else 4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _array(self, n: int) -> list:
        return [self.unpack() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.unpack()
            out[key] = self.unpack()
        return out

    def _ext(self, code: int, n: int):
        payload = self._take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype_name, buffer = unpackb(payload)
            arr = np.frombuffer(
                buffer, dtype=np.dtype(dtype_name)
            ).reshape(shape, order="C")
            return arr if code == _EXT_NDARRAY else arr[()]
        raise ValueError(f"unknown msgpack extension type {code}")


def unpackb(data: bytes):
    """Decode one msgpack document (Flax's extension types included)."""
    unpacker = _Unpacker(bytes(data))
    out = unpacker.unpack()
    if unpacker.pos != len(unpacker.data):
        raise ValueError("trailing bytes after msgpack document")
    return out


def _pack_uint_header(n: int, fix_base: int | None, fix_max: int,
                      codes: tuple) -> bytes:
    """A length header: the fix form below ``fix_max``, else the shortest
    of the 8/16/32-bit forms (``codes``; None where a form is missing)."""
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    for code, size in zip(codes, (1, 2, 4)):
        if code is not None and n < (1 << (8 * size)):
            return bytes([code]) + n.to_bytes(size, "big")
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return bytes([v & 0xFF])
    if v > 0:
        for code, size in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if v < (1 << (8 * size)):
                return bytes([code]) + v.to_bytes(size, "big")
    else:
        for code, size in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if v >= -(1 << (8 * size - 1)):
                return bytes([code]) + v.to_bytes(size, "big", signed=True)
    raise ValueError(f"integer {v} out of msgpack range")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _pack_uint_header(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + code.to_bytes(1, "big", signed=True) + payload


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        out.append(_pack_ext(_EXT_NDARRAY, _array_payload(obj)))
    elif isinstance(obj, np.generic):
        out.append(_pack_ext(_EXT_NPSCALAR, _array_payload(np.asarray(obj))))
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode()
        out.append(_pack_uint_header(len(raw), 0xA0, 31,
                                     (0xD9, 0xDA, 0xDB)) + raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_pack_uint_header(len(obj), None, 0,
                                     (0xC4, 0xC5, 0xC6)) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_uint_header(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_pack_uint_header(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def _array_payload(arr: np.ndarray) -> bytes:
    """Flax's ndarray payload: msgpack ``[shape, dtype name, C bytes]``."""
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def packb(obj) -> bytes:
    """Encode one msgpack document as Flax's ``msgpack_serialize`` does."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def save_checkpoint(path: Path, payload: dict) -> None:
    """Write ``payload`` (string-keyed maps, ints, floats, numpy leaves) as
    a Flax msgpack checkpoint, atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(packb(payload))
    tmp.replace(path)


def adam_state_to_jax(optimizer: torch.optim.Adam, names: dict,
                      to_tree, scheduled: bool = False) -> dict:
    """optax ``adam`` state of ``optimizer`` as Flax serializes it:
    ``{"0": {"count": int32 0-d, "mu": tree, "nu": tree}, "1": {}}``;
    with ``scheduled`` (``adam(schedule)``) ``"1"`` holds the schedule's
    count, equal to Adam's.  ``names`` maps each parameter to its
    ``state_dict`` key, ``to_tree`` maps a key -> tensor dict onto the
    parameter tree.  Before the first step the moments are zero and the
    count 0."""
    mu, nu, count = {}, {}, 0
    for param, key in names.items():
        st = optimizer.state.get(param, {})
        mu[key] = st.get("exp_avg", torch.zeros_like(param))
        nu[key] = st.get("exp_avg_sq", torch.zeros_like(param))
        if "step" in st:
            count = int(st["step"])
    count = np.asarray(count, np.int32)
    return {"0": {"count": count, "mu": to_tree(mu), "nu": to_tree(nu)},
            "1": {"count": count.copy()} if scheduled else {}}


def adam_state_from_jax(optimizer: torch.optim.Adam, names: dict,
                        opt_state: dict, from_tree) -> None:
    """Load an optax ``adam`` state (as ``adam_state_to_jax`` writes it)
    into ``optimizer``: step = count, exp_avg = mu, exp_avg_sq = nu.
    ``from_tree`` maps a parameter tree onto ``state_dict`` keys."""
    adam = opt_state["0"]
    mu, nu = from_tree(adam["mu"]), from_tree(adam["nu"])
    step = float(adam["count"])
    for param, key in names.items():
        optimizer.state[param] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[key].to(param).clone(),
            "exp_avg_sq": nu[key].to(param).clone(),
        }


def load_checkpoint(path: Path) -> dict:
    """Checkpoint payload, the tree ``flax.serialization.msgpack_restore``
    gives: {"params", "opt_state", "step", ...} with numpy leaves
    (conv payloads also carry channels; NeuralFSAI payloads width,
    hidden, poly_degree, power)."""
    return unpackb(Path(path).read_bytes())
