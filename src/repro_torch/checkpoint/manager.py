"""Atomic, asynchronous, verified checkpoints (counterpart of
``repro.checkpoint.manager``).

The same guarantees as the reference:

* **Atomicity** -- a checkpoint is staged into ``step_<n>.tmp`` and
  ``os.rename``d into place only when fully written.
* **Asynchrony** -- ``save(blocking=False)`` takes a device-side snapshot
  (one ``clone`` per tensor leaf) on the caller and returns (a blocking
  save needs no snapshot and takes none); the
  device-to-host copy, the packing and the writing run on a writer thread.
  ``wait()`` fences, and an ``atexit`` hook fences a save still in flight
  when the interpreter exits.
* **Compactness** -- with a ``fmt`` grid, float32 leaves whose values lie
  on that grid are stored as packed uint8/uint16 codes, the layout of
  ``kernels.common.pack_block``.  Packing is self-validating: a leaf is
  encoded, decoded and compared bitwise, and a leaf that does not
  round-trip is stored raw, so restore is bit-exact whatever the leaves
  hold.  A tensor leaf is packed where it lies, before its host copy, with
  ``pack_block``; a numpy leaf with :func:`pack_np` (the reference's numpy
  codec, the same codes).  Either works through a leaf ``CHUNK`` elements
  at a time: ``pack_np``'s float64 temporaries would otherwise take tens
  of GB for a billion-element leaf.  Leaves go to several size-balanced
  ``leaves*.npz`` shards.
* **Integrity** -- ``meta.json`` (``format: 2``) records a SHA-256 of
  every file and each leaf's ``packed`` grid; ``restore()`` with no step
  verifies and falls back to the newest intact checkpoint.  Writes retry
  transient I/O errors with capped exponential backoff; ``keep`` bounds
  the checkpoints on disk.

The tree structure is written as the reference writes it, a pickled jax
treedef (``treedef.pkl``), so that ``repro.checkpoint.CheckpointManager``
restores a checkpoint of the port (and verifies it by the same digests):
nested dicts, lists, tuples and the optimizer states ``QAdamState`` and
``QSGDState`` (written as the reference's classes of those names) whose
leaves are tensors, numpy arrays, Python ints, floats and bools, and
``None``, which is a node of the tree and not a leaf, as in jax.  An
optimizer state's ``step`` is stored as the reference's int32 scalar and
its ``key`` (a pair of Python ints in the port) as the reference's uint32
(2,) array, so that the tree has the reference's structure; a bfloat16
tensor is stored as 2-byte void, as numpy saves the reference's bfloat16
arrays.  Each leaf's meta records what it was in the port (``kind``,
``dtype``), so ``restore`` gives back the port's own tree:
``restore(device=)`` puts tensor leaves on a device and decodes them there
(the counterpart of the reference's ``shardings``).  The pickle is made by
a small opcode writer and needs neither jax nor the reference: it names
jax's treedef class and default registry as globals.  A node the
reference cannot read (any other NamedTuple, a dict key that is not a str
or int) is refused when saving, naming it.

``restore`` also reads a checkpoint the reference wrote, verified by the
same digests, without importing jax or the reference: a restricted
unpickler maps the two globals such a pickle names (the treedef class and
jax's default registry) to stand-ins that keep the treedef's node
records, maps the reference's optimizer states to the port's classes of
the same name, and refuses every other global.  A leaf without the port's
meta (one the reference wrote) comes back as a numpy array, as the
reference's restore gives it; the trainer's state then goes through
``repro_torch.convert`` (``master_params_from_jax``,
``qadam_state_from_jax``).  Checkpoints that earlier versions of the port
wrote, with their structure as JSON (``treedef.json``), still restore.
"""
from __future__ import annotations

import atexit
import hashlib
import importlib
import io
import json
import os
import pickle
import shutil
import threading
import time
import weakref
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.grids import get_grid
from repro_torch.core.schemes import IDENTITY_NAMES, parse_spec_name
from repro_torch.kernels.common import pack_block, pack_spec, unpack_block

FORMAT = 2
CHUNK = 1 << 24             # elements per packing pass

# transient-I/O retry schedule: attempts, initial delay, cap (seconds)
_WRITE_ATTEMPTS = 3
_WRITE_DELAY = 0.05
_WRITE_DELAY_CAP = 1.0


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Packed grid codes in numpy (sign | biased exponent | mantissa), exact:
# ldexp is an exact power-of-two scaling in float64 and every grid
# significand fits 24 bits.
# ---------------------------------------------------------------------------
def _grid_pack_params(grid_name: str):
    fmt = get_grid(grid_name).fmt
    ebits, mbits, width, has_nf = pack_spec(grid_name)
    return fmt, ebits, mbits, width, has_nf


def pack_np(x: np.ndarray, grid_name: str) -> np.ndarray:
    """float32 values on ``grid_name``'s grid -> packed uint8/uint16
    codes."""
    fmt, ebits, mbits, width, has_nf = _grid_pack_params(grid_name)
    x = np.asarray(x, np.float32)
    sign = np.signbit(x).astype(np.uint32)
    finite = np.isfinite(x)
    mag_f = np.where(finite, np.abs(x), np.float32(fmt.xmax))
    is_sub = mag_f < np.float32(fmt.xmin)
    raw_exp = ((mag_f.view(np.uint32) >> 23) & 0xFF).astype(np.int64)
    e = np.where(is_sub, np.int64(fmt.emin), raw_exp - 127)
    q = np.ldexp(mag_f.astype(np.float64), mbits - e)
    m = q.astype(np.uint32) & np.uint32((1 << mbits) - 1)
    field = np.where(is_sub, np.uint32(0),
                     (e - fmt.emin + 1).astype(np.uint32))
    code = (sign << np.uint32(ebits + mbits)) | (field << np.uint32(mbits)) | m
    if has_nf:
        m_nf = np.where(np.isnan(x), np.uint32((1 << mbits) - 1),
                        np.uint32(0))
        code_nf = (sign << np.uint32(ebits + mbits)) \
            | (np.uint32((1 << ebits) - 1) << np.uint32(mbits)) | m_nf
        code = np.where(finite, code, code_nf)
    return code.astype(np.uint8 if width == 1 else np.uint16)


def unpack_np(codes: np.ndarray, grid_name: str) -> np.ndarray:
    """Inverse of :func:`pack_np`: exact float32 grid values."""
    fmt, ebits, mbits, _, has_nf = _grid_pack_params(grid_name)
    c = np.asarray(codes).astype(np.uint32)
    sign = (c >> np.uint32(ebits + mbits)) & np.uint32(1)
    field = (c >> np.uint32(mbits)) & np.uint32((1 << ebits) - 1)
    m = c & np.uint32((1 << mbits) - 1)
    is_sub = field == 0
    e = np.where(is_sub, np.int64(fmt.emin),
                 field.astype(np.int64) - 1 + fmt.emin)
    sig = np.where(is_sub, m, m + np.uint32(1 << mbits)).astype(np.float64)
    with np.errstate(over="ignore"):    # non-finite codes overwritten below
        out = np.ldexp(sig, e - mbits).astype(np.float32)
    out = np.where(sign == 1, -out, out)
    out = np.where((sig == 0) & (sign == 1), np.float32(-0.0), out)
    if has_nf:
        nf = field == (1 << ebits) - 1
        inf = np.where(sign == 1, -np.inf, np.inf).astype(np.float32)
        out = np.where(nf, np.where(m == 0, inf, np.float32(np.nan)), out)
    return out


def resolve_ckpt_grid(fmt: Optional[str]) -> Optional[str]:
    """Validate a ``--ckpt-fmt`` value and return the canonical grid name:
    a canonical spec name (``"bf16-sr"``; the scheme is ignored), a bare
    grid name (``"e4m3"``), or ``"fp32"``/``"none"``/None for no packing.
    Raises on unknown names and on grids too wide to pack."""
    if fmt is None or fmt in IDENTITY_NAMES:
        return None
    parsed = parse_spec_name(fmt if "-" in fmt else f"{fmt}-rn")
    if parsed.grid is None:
        return None
    pack_spec(parsed.grid)           # raise early on unpackable grids
    return parsed.grid


def _pack_checked(flat, grid_name: str, pack, unpack, as_bits, empty):
    """Codes of a flat float32 array, ``CHUNK`` elements at a time, or None
    where an element does not decode to its own bits (off-grid values)."""
    codes = None
    for lo in range(0, flat.shape[0], CHUNK):
        part = flat[lo:lo + CHUNK]
        c = pack(part, grid_name)
        if not (as_bits(unpack(c, grid_name)) == as_bits(part)).all():
            return None
        if codes is None:
            codes = empty(flat.shape[0], c)
        codes[lo:lo + CHUNK] = c
    return codes


def pack_checked(x, grid_name: str):
    """The self-validating encode: ``x``'s packed codes if every element
    round-trips bitwise, else None.  A tensor is packed where it lies with
    ``kernels.common.pack_block``, a numpy array with :func:`pack_np`;
    both give the same codes."""
    if torch.is_tensor(x):
        codes = _pack_checked(
            x.reshape(-1), grid_name, pack_block, unpack_block,
            lambda t: t.view(torch.int32),
            lambda n, c: torch.empty(n, dtype=c.dtype, device=c.device))
    else:
        codes = _pack_checked(
            x.reshape(-1), grid_name, pack_np, unpack_np,
            lambda a: a.view(np.uint32), lambda n, c: np.empty(n, c.dtype))
    return None if codes is None else codes.reshape(x.shape)


def unpack_chunked(codes, grid_name: str):
    """Codes back to float32 values, ``CHUNK`` elements at a time, with
    the codec of where they lie (tensor or numpy array)."""
    flat = codes.reshape(-1)
    if torch.is_tensor(codes):
        out = torch.empty(flat.shape[0], dtype=torch.float32,
                          device=codes.device)
        unpack = unpack_block
    else:
        out, unpack = np.empty(flat.shape[0], np.float32), unpack_np
    for lo in range(0, flat.shape[0], CHUNK):
        out[lo:lo + CHUNK] = unpack(flat[lo:lo + CHUNK], grid_name)
    return out.reshape(codes.shape)


# ---------------------------------------------------------------------------
# The tree, walked as the port's trees are (the structure of checkpoints
# that earlier versions wrote as JSON, and the loop's device moves)
# ---------------------------------------------------------------------------
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, structure): dict keys sorted, lists, tuples and
    NamedTuples in order; anything else is a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
        node = {"t": "dict", "k": keys}
    elif _is_namedtuple(tree):
        parts = [flatten(v) for v in tree]
        cls = type(tree)
        node = {"t": "namedtuple", "cls": f"{cls.__module__}:"
                f"{cls.__qualname__}"}
    elif isinstance(tree, (list, tuple)):
        parts = [flatten(v) for v in tree]
        node = {"t": type(tree).__name__}
    else:
        return [tree], {"t": "leaf"}
    node["c"] = [p[1] for p in parts]
    return [leaf for p in parts for leaf in p[0]], node


def unflatten(node, leaves):
    it = iter(leaves)

    def build(d):
        kind = d["t"]
        if kind == "leaf":
            return next(it)
        children = [build(c) for c in d["c"]]
        if kind == "dict":
            return dict(zip(d["k"], children))
        if kind == "list":
            return children
        if kind == "tuple":
            return tuple(children)
        module, name = d["cls"].split(":")
        cls = importlib.import_module(module)
        for part in name.split("."):
            cls = getattr(cls, part)
        return cls(*children)
    return build(node)


# ---------------------------------------------------------------------------
# The reference's treedef.pkl, written and read without jax
# ---------------------------------------------------------------------------
# jax pickles a PyTreeDef as this class, its state (the default registry,
# [records]): one record per node in post-order, (kind, arity, node_data,
# custom, num_leaves, num_nodes).
_REF_TREEDEF = ("jaxlib._jax.pytree", "PyTreeDef")
_REF_REGISTRY = ("jax._src.tree_util", "default_registry")
# node kinds: a leaf, None (no leaf), tuple, NamedTuple (node_data: the
# class), list, dict (node_data: the sorted keys)
_LEAF, _NONE, _TUPLE, _NAMEDTUPLE, _LIST, _DICT = range(6)
# the reference's NamedTuple states -> the port's classes of the same name
_REF_NAMEDTUPLES = {
    ("repro.optim.adam", "QAdamState"): ("repro_torch.optim.adam",
                                         "QAdamState"),
    ("repro.optim.sgd", "QSGDState"): ("repro_torch.optim.sgd",
                                       "QSGDState"),
}
_PORT_NAMEDTUPLES = {port: ref for ref, port in _REF_NAMEDTUPLES.items()}


class _Stored:
    """A leaf stored in the reference's form (an optimizer state's step or
    key), with the kind that gives the port's value back."""

    def __init__(self, array: np.ndarray, kind: str):
        self.array, self.kind = array, kind


def _state_field(name: str, value):
    """An optimizer state's field as the reference holds it: the step as an
    int32 scalar, the key words as a uint32 (2,) array."""
    if name == "step" and isinstance(value, int) \
            and not isinstance(value, bool):
        return _Stored(np.asarray(value, np.int32), "int")
    if name == "key" and isinstance(value, tuple) and len(value) == 2 \
            and all(isinstance(w, int) for w in value):
        return _Stored(np.asarray(value, np.uint32), "key")
    return value


def ref_flatten(tree, path: str = "tree") -> Tuple[List[Any], List[tuple]]:
    """(leaves, records): the tree as jax flattens the reference's tree of
    the same data, the records in post-order as ``(kind, arity,
    node_data, num_leaves, num_nodes)``; a NamedTuple's node_data is the
    reference class's (module, name).  Raises on a node the reference
    cannot read, naming its path."""
    leaves: List[Any] = []
    records: List[tuple] = []

    def walk(x, where):
        n_leaves0, n_nodes0 = len(leaves), len(records)
        if x is None:
            records.append((_NONE, 0, None, 0, 1))
            return
        if isinstance(x, dict):
            keys = list(x)
            if not all(isinstance(k, str) for k in keys) \
                    and not all(isinstance(k, int) and not isinstance(k, bool)
                                for k in keys):
                raise TypeError(f"{where}: dict keys {keys!r} are not all "
                                "str or all int; the reference's treedef "
                                "cannot hold them")
            keys = sorted(keys)
            for k in keys:
                walk(x[k], f"{where}[{k!r}]")
            kind, arity, data = _DICT, len(keys), keys
        elif _is_namedtuple(x):
            cls = type(x)
            ref = _PORT_NAMEDTUPLES.get((cls.__module__, cls.__qualname__))
            if ref is None:
                raise TypeError(
                    f"{where}: a {cls.__module__}.{cls.__qualname__} "
                    "NamedTuple, which the reference cannot read (its "
                    "checkpoints hold QAdamState and QSGDState)")
            for name, v in zip(x._fields, x):
                walk(_state_field(name, v), f"{where}.{name}")
            kind, arity, data = _NAMEDTUPLE, len(x), ref
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{where}[{i}]")
            kind = _LIST if isinstance(x, list) else _TUPLE
            arity, data = len(x), None
        else:
            leaves.append(x)
            records.append((_LEAF, 0, None, 1, 1))
            return
        records.append((kind, arity, data, len(leaves) - n_leaves0,
                        len(records) - n_nodes0 + 1))

    walk(tree, path)
    return leaves, records


def _pickle_int(v: int) -> bytes:
    if 0 <= v < 1 << 8:
        return b"K" + v.to_bytes(1, "little")              # BININT1
    if 0 <= v < 1 << 16:
        return b"M" + v.to_bytes(2, "little")              # BININT2
    return b"J" + v.to_bytes(4, "little", signed=True)     # BININT


def _pickle_global(module: str, name: str) -> bytes:
    return b"c" + module.encode() + b"\n" + name.encode() + b"\n"


def treedef_pickle(records: List[tuple]) -> bytes:
    """The bytes of a pickled jax treedef (protocol 2) over ``records``, as
    ``pickle.dumps`` of a ``PyTreeDef`` lays them out: the class, NEWOBJ,
    then BUILD with (registry, [records])."""
    out = [b"\x80\x02", _pickle_global(*_REF_TREEDEF), b")\x81",
           _pickle_global(*_REF_REGISTRY), b"]("]
    for kind, arity, data, n_leaves, n_nodes in records:
        out.append(b"(" + _pickle_int(kind) + _pickle_int(arity))
        if kind == _NAMEDTUPLE:
            out.append(_pickle_global(*data))
        elif kind == _DICT:
            out.append(b"](")
            for k in data:
                if isinstance(k, str):
                    raw = k.encode()
                    out.append(b"X" + len(raw).to_bytes(4, "little") + raw)
                else:
                    out.append(b"\x8a" + bytes([8]) + k.to_bytes(
                        8, "little", signed=True))          # LONG1
            out.append(b"e")
        else:
            out.append(b"N")
        out.append(b"N" + _pickle_int(n_leaves) + _pickle_int(n_nodes)
                   + b"t")
    out.append(b"e\x86b.")
    return b"".join(out)


class _RefTreeDef:
    """A pickled jax treedef's node records."""

    def __setstate__(self, state):
        _registry, records = state
        self.records = [tuple(r) for r in records]


class _RefUnpickler(pickle.Unpickler):
    """Unpickles a ``treedef.pkl``: the treedef and registry globals become
    stand-ins, the reference's optimizer states the port's classes; any
    other global is refused."""

    def find_class(self, module, name):
        if (module, name) == _REF_TREEDEF:
            return _RefTreeDef
        if (module, name) == _REF_REGISTRY:
            return None
        if (module, name) in _REF_NAMEDTUPLES:
            mod, cls = _REF_NAMEDTUPLES[(module, name)]
            return getattr(importlib.import_module(mod), cls)
        raise pickle.UnpicklingError(
            f"treedef.pkl names the global {module}.{name}, which a "
            "reference checkpoint's tree may not hold")


def _ref_unflatten(data: bytes, leaves):
    """The tree of a ``treedef.pkl`` over ``leaves``."""
    treedef = _RefUnpickler(io.BytesIO(data)).load()
    if not isinstance(treedef, _RefTreeDef):
        raise pickle.UnpicklingError("treedef.pkl does not hold a jax "
                                     "treedef")
    it = iter(leaves)
    stack: List[Any] = []
    for kind, arity, node_data, _custom, _n_leaves, _n_nodes in \
            treedef.records:
        if kind == _LEAF:
            stack.append(next(it))
            continue
        if kind == _NONE:
            stack.append(None)
            continue
        if arity > len(stack):
            raise ValueError("treedef.pkl: a node has more children than "
                             "the records before it")
        children = stack[len(stack) - arity:]
        del stack[len(stack) - arity:]
        if kind == _TUPLE:
            stack.append(tuple(children))
        elif kind == _LIST:
            stack.append(children)
        elif kind == _DICT:
            stack.append(dict(zip(node_data, children)))
        elif kind == _NAMEDTUPLE:
            stack.append(node_data(*children))
        else:
            raise ValueError(f"treedef.pkl: node kind {kind} (a custom or "
                             "dataclass node) is not read")
    if len(stack) != 1 or next(it, None) is not None:
        raise ValueError("treedef.pkl does not match the stored leaves")
    return stack[0]


def _snap_leaf(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return np.array(x, copy=True)
    return x


def _host_leaf(x) -> Tuple[np.ndarray, dict]:
    """(array to store, leaf meta) of one snapshot leaf, not yet packed; a
    bfloat16 tensor as 2-byte void, the dtype numpy gives the reference's
    bfloat16 arrays when it saves them."""
    if torch.is_tensor(x):
        t = x.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.void(2).dtype), {
                "kind": "tensor", "dtype": "bfloat16"}
        return t.numpy(), {"kind": "tensor"}
    if isinstance(x, np.ndarray):
        return x, {"kind": "ndarray"}
    if isinstance(x, _Stored):
        return x.array, {"kind": x.kind}
    if isinstance(x, (bool, int, float)):
        return np.asarray(x), {"kind": type(x).__name__}
    raise TypeError(f"cannot checkpoint a leaf of type {type(x).__name__}")


def _from_host(arr, meta, device):
    """A stored leaf as the port held it (``None`` is a leaf of this kind
    only in checkpoints written as JSON)."""
    kind = meta["kind"]
    if kind == "none":
        return None
    if kind == "ndarray":
        return unpack_chunked(arr, meta["packed"]) if meta.get("packed") \
            else arr
    if kind == "tensor":
        if meta.get("dtype") == "bfloat16":
            arr = arr.view(np.int16)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device is not None:
            t = t.to(device)
        if meta.get("packed"):
            return unpack_chunked(t, meta["packed"])
        return t.view(torch.bfloat16) if meta.get("dtype") == "bfloat16" \
            else t
    if kind == "key":
        return tuple(int(w) for w in arr.reshape(-1))
    return {"bool": bool, "int": int, "float": float}[kind](arr.item())


def _atexit_fence(ref):
    mgr = ref()
    if mgr is not None:
        mgr._join()          # flush, never raise during interpreter exit


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 fmt: Optional[str] = None, shards: int = 4):
        self.directory = directory
        self.keep = keep
        self.fmt = resolve_ckpt_grid(fmt)
        self.shards = max(1, int(shards))
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        atexit.register(_atexit_fence, weakref.ref(self))

    # ------------------------------------------------------------------ save
    def _encode_leaf(self, x) -> Tuple[np.ndarray, dict]:
        """(array to store, leaf meta) of a snapshot leaf: a float32 leaf
        on the ``fmt`` grid as its codes (packed where it lies), anything
        else as it is."""
        if torch.is_tensor(x):
            packable = x.dtype == torch.float32 and x.numel() > 0
        else:
            packable = isinstance(x, np.ndarray) and x.dtype == np.float32 \
                and x.size > 0
        if self.fmt is not None and packable:
            codes = pack_checked(x, self.fmt)
            if codes is not None:
                arr, meta = _host_leaf(codes)
                kind = "tensor" if torch.is_tensor(x) else "ndarray"
                return arr, {**meta, "kind": kind, "packed": self.fmt}
        arr, meta = _host_leaf(x)
        return arr, {**meta, "packed": None}

    @staticmethod
    def _shard_name(k: int) -> str:
        # shard 0 keeps the name fault injection targets ("leaves.npz")
        return "leaves.npz" if k == 0 else f"leaves.{k}.npz"

    def _assign_shards(self, arrays) -> List[int]:
        """Greedy size-balanced shard index per stored array."""
        n_shards = min(self.shards, max(1, len(arrays)))
        loads = [0] * n_shards
        assign = [0] * len(arrays)
        order = sorted(range(len(arrays)), key=lambda i: -arrays[i].nbytes)
        for i in order:
            k = loads.index(min(loads))
            assign[i] = k
            loads[k] += max(arrays[i].nbytes, 1)
        return assign

    def save(self, step: int, tree: Any, *, blocking: bool = False,
             extra: Optional[dict] = None):
        """Checkpoint a tree.  A non-blocking save snapshots on the device
        and hands off; the host copy happens on the writer thread.  A
        blocking save writes the leaves as they are: nothing can change
        them before it returns."""
        self.wait()
        leaves, records = ref_flatten(tree)
        treedef = treedef_pickle(records)
        snap = leaves if blocking else [_snap_leaf(x) for x in leaves]
        ready = None
        if any(torch.is_tensor(x) and x.is_cuda for x in snap):
            ready = torch.cuda.Event()
            ready.record()

        def write_once(host):
            tmp = os.path.join(self.directory, f"step_{step}.tmp")
            final = os.path.join(self.directory, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            stored = [arr for arr, _ in host]
            leaf_meta = [meta for _, meta in host]
            assign = self._assign_shards(stored)
            n_shards = (max(assign) + 1) if assign else 1
            for i, k in enumerate(assign):
                leaf_meta[i]["file"] = self._shard_name(k)
            for k in range(n_shards):
                np.savez(os.path.join(tmp, self._shard_name(k)),
                         **{f"leaf_{i}": stored[i]
                            for i, s in enumerate(assign) if s == k})
            with open(os.path.join(tmp, "treedef.pkl"), "wb") as f:
                f.write(treedef)
            hashed = [self._shard_name(k) for k in range(n_shards)] \
                + ["treedef.pkl"]
            digests = {name: _sha256(os.path.join(tmp, name))
                       for name in hashed}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "extra": extra or {},
                           "format": FORMAT, "sha256": digests,
                           "leaves": leaf_meta}, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        def write():
            try:
                if ready is not None:
                    ready.synchronize()
                host = [self._encode_leaf(x) for x in snap]
            except Exception as e:       # surfaced on the next save/wait
                self._error = e
                return
            delay = _WRITE_DELAY
            for attempt in range(_WRITE_ATTEMPTS):
                try:
                    write_once(host)
                    return
                except OSError as e:       # transient I/O: retry w/ backoff
                    if attempt == _WRITE_ATTEMPTS - 1:
                        self._error = e
                        return
                    time.sleep(delay)
                    delay = min(delay * 2, _WRITE_DELAY_CAP)
                except Exception as e:      # surfaced on the next save/wait
                    self._error = e
                    return

        if blocking:
            write()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _join(self):
        """Fence the background write without raising."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def wait(self):
        self._join()
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self._list_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def _list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name[5:].isdigit():
                out.append(int(name[5:]))
        return sorted(out)

    def all_steps(self) -> List[int]:
        # fence first: a step mid-write must not be invisible to callers
        # deciding whether durable state exists
        self._join()
        return self._list_steps()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify(self, step: int) -> bool:
        """True iff the step's files are present and match their recorded
        checksums."""
        path = os.path.join(self.directory, f"step_{step}")
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return False
        digests = meta.get("sha256")
        if meta.get("format") != FORMAT or not digests:
            return False
        for name, digest in digests.items():
            fpath = os.path.join(path, name)
            if not os.path.exists(fpath) or _sha256(fpath) != digest:
                return False
        return True

    def _load(self, step: int, device):
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        files, leaves = {}, []
        for i, entry in enumerate(meta["leaves"]):
            arr = None
            if "file" in entry:
                name = entry["file"]
                if name not in files:
                    files[name] = np.load(os.path.join(path, name))
                arr = files[name][f"leaf_{i}"]
            if "kind" in entry:        # a leaf the port wrote
                leaves.append(_from_host(arr, entry, device))
            else:      # the reference's: numpy, as the reference restores
                leaves.append(unpack_np(arr, entry["packed"])
                              if entry.get("packed") else arr)
        legacy = os.path.join(path, "treedef.json")
        if os.path.exists(legacy):     # written by an earlier port
            with open(legacy) as f:
                tree = unflatten(json.load(f), leaves)
        else:
            with open(os.path.join(path, "treedef.pkl"), "rb") as f:
                tree = _ref_unflatten(f.read(), leaves)
        return step, tree, meta.get("extra", {})

    def restore(self, step: Optional[int] = None, device=None):
        """Load a checkpoint; returns (step, tree, extra), tensor leaves on
        ``device`` (default: the CPU; a reference checkpoint's leaves are
        numpy arrays).  With no ``step``, verifies candidates newest first
        and loads the newest intact one; an explicit ``step`` that fails
        verification raises ``IOError``."""
        self.wait()
        if step is not None:
            if not self.verify(step):
                raise IOError(f"checkpoint step_{step} in {self.directory} "
                              "is corrupt or incomplete")
            return self._load(step, device)
        for s in reversed(self._list_steps()):
            if self.verify(s):
                return self._load(s, device)
        raise FileNotFoundError(f"no intact checkpoints in {self.directory}")
