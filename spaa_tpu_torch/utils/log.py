"""Config-string naming, the ``.flax`` checkpoint codec, the training
resume snapshot and the metrics log.

Counterpart of ``spaa_tpu/utils/log.py``. The config string is a de-facto
API (checkpoint and result directory names) and is kept byte-identical.
Checkpoints are the msgpack files ``flax.serialization.to_bytes`` writes;
the GPU machine has neither flax nor msgpack, so :func:`msgpack_restore`
reads the subset flax emits (maps, strings, binaries, arrays, scalars and
the array extensions: ext type 1 for an ndarray, 3 for a numpy scalar,
each itself a msgpack ``(shape, dtype name, C-order bytes)``) and
:func:`msgpack_pack` writes param trees: maps of ndarrays. The metrics
log is ``spaa_tpu``'s pandas log, written from a :class:`~.table.Table`
(the same CSV, ``%.4f``, and the same ``.xlsx``).
"""

from __future__ import annotations

import os
import struct
import time
from os.path import abspath, join

import numpy as np
import torch

from spaa_tpu_torch.utils.config import save_flat_yaml
from spaa_tpu_torch.utils.table import Table, read_csv
from spaa_tpu_torch.utils.xlsx import to_excel


def opt_to_string(opt) -> str:
    """Training title string (ref ``utils.py:673-675``)."""
    return (f'{opt["setup_name"]}_{opt["model_name"]}_{opt["loss"]}_'
            f'{opt["num_train"]}_{opt["batch_size"]}_{opt["max_iters"]}_'
            f'{opt["lr"]}_{opt["lr_drop_ratio"]}_{opt["lr_drop_rate"]}_'
            f'{opt["l2_reg"]}')


def checkpoint_path(checkpoint_dir: str, title: str) -> str:
    return abspath(join(checkpoint_dir, title + ".flax"))


def resume_path(checkpoint_dir: str, title: str) -> str:
    """Crash-recovery train-state file of a run (config-string keyed like
    the final checkpoint; removed on completion)."""
    return checkpoint_path(checkpoint_dir, title) + ".resume.npz"


_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xDC: ("H", "array"), 0xDD: ("I", "array"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map"),
                 0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack("b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack("b"), fixext[b])
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int):
        return [self.obj() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        inner = _Reader(payload)
        shape, dtype_name, buf = inner.obj()
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(data: bytes):
    """Decode a flax msgpack checkpoint into nested dicts of numpy arrays
    (the same tree ``flax.serialization.msgpack_restore`` returns)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load_checkpoint(path: str):
    """Read a ``.flax`` checkpoint -> nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _header(n: int, fix: int, fix_max: int, wide: tuple) -> bytes:
    """A msgpack length header: fix form up to ``fix_max``, else the first
    of the 8/16/32-bit forms ``wide`` = (code8 or None, code16, code32)
    that holds ``n``."""
    if n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(wide, ("B", "H", "I"), (0xFF, 0xFFFF,
                                                      0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(">" + fmt, n)
    raise ValueError("msgpack object too large")


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF),
                               (0xCE, "I", 0xFFFFFFFF), (0xCF, "Q", 2**64 - 1)):
            if v <= top:
                return bytes([code]) + struct.pack(">" + fmt, v)
    for code, fmt, lo in ((0xD0, "b", -2**7), (0xD1, "h", -2**15),
                          (0xD2, "i", -2**31), (0xD3, "q", -2**63)):
        if v >= lo:
            return bytes([code]) + struct.pack(">" + fmt, v)
    raise ValueError("integer out of msgpack range")


def _pack_ext(code: int, payload: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    head = (bytes([fixext[n]]) if n in fixext
            else _header(n, 0, -1, (0xC7, 0xC8, 0xC9)))
    return head + struct.pack(">b", code) + payload


def _pack(obj, out: list) -> None:
    if isinstance(obj, int) and not isinstance(obj, bool):
        out.append(_pack_int(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_header(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_header(len(obj), 0, -1, (0xC4, 0xC5, 0xC6)) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        payload = msgpack_pack((obj.shape, obj.dtype.name, obj.tobytes("C")))
        out.append(_pack_ext(_EXT_NDARRAY, payload))
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def msgpack_pack(obj) -> bytes:
    """Encode nested dicts (string keys) of numpy arrays as
    ``flax.serialization.to_bytes`` does (msgpack with ``use_bin_type``,
    keys in the dicts' own order)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def save_checkpoint(checkpoint_dir: str, params: dict, title: str) -> str:
    """Write a param tree (nested dicts of numpy arrays) as the ``.flax``
    checkpoint ``spaa_tpu`` writes (ref ``utils.py:717-721``)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = checkpoint_path(checkpoint_dir, title)
    with open(path, "wb") as f:
        f.write(msgpack_pack(params))
    print(f"Checkpoint saved to {path}\n")
    return path


# ---------------------------------------------------------- resume snapshot
_STATE_FORMAT = "spaa_tpu_torch train state 1"


def save_train_state(path: str, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, itr: int,
                     fingerprint: int) -> None:
    """Atomic (model, optimizer moments, iteration) snapshot, with the
    fingerprint of the training data and index plan. An npz of the port's
    own layout: ``model:<name>``, ``opt:<param index>:<key>``."""
    payload = {"format": np.array(_STATE_FORMAT), "iter": np.int64(itr),
               "fingerprint": np.uint64(fingerprint)}
    for name, t in model.state_dict().items():
        payload[f"model:{name}"] = t.detach().cpu().numpy()
    for idx, st in optimizer.state_dict()["state"].items():
        for k, v in st.items():
            payload[f"opt:{idx}:{k}"] = torch.as_tensor(v).cpu().numpy()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:      # a file object: savez adds no suffix
        np.savez(f, **payload)
    os.replace(tmp, path)           # never leave a torn file behind


def load_train_state(path: str):
    """Read a :func:`save_train_state` snapshot: ``(model state_dict,
    optimizer state by parameter index, iteration, fingerprint)``. Raises
    ``ValueError`` for a file of another layout (e.g. ``spaa_tpu``'s)."""
    with np.load(path) as data:
        if "format" not in data.files or str(data["format"]) != _STATE_FORMAT:
            raise ValueError(f"{path} is not a spaa_tpu_torch train state")
        model_sd = {k[len("model:"):]: torch.from_numpy(data[k])
                    for k in data.files if k.startswith("model:")}
        opt_state: dict = {}
        for k in data.files:
            if k.startswith("opt:"):
                _, idx, key = k.split(":")
                opt_state.setdefault(int(idx), {})[key] = \
                    torch.from_numpy(data[k])
        return model_sd, opt_state, int(data["iter"]), int(data["fingerprint"])


# ------------------------------------------------------------- metrics log
LOG_COLUMNS = ["Setup", "Model", "Loss", "Num train", "Batch", "Iters",
               "PSNR", "RMSE", "SSIM", "L2", "L-inf", "dE"]


def init_log_file(log_dir: str):
    """A fresh metrics :class:`~.table.Table` and its timestamped ``.txt``
    and ``.xlsx`` paths (ref ``utils.py:678-684``)."""
    os.makedirs(log_dir, exist_ok=True)
    stamp = time.strftime("%Y-%m-%d_%H_%M_%S", time.localtime())
    return (Table(LOG_COLUMNS), join(log_dir, stamp + ".txt"),
            join(log_dir, stamp + ".xlsx"))


def add_mean_row(table: Table, model_name: str, n_setups: int) -> None:
    """Per-model mean of the numeric columns (ref
    ``train_network.py:584-586``), as pandas' ``mean(numeric_only=True)``
    sums them."""
    sel = [r for r in table.typed_rows() if r[1] == model_name]
    mean = [None] * len(table.columns)
    for c in range(3, len(table.columns)):
        vals = [r[c] for r in sel if r[c] is not None]
        mean[c] = (float(np.sum(np.asarray(vals, np.float64)) / len(vals))
                   if vals else None)
    mean[0], mean[1] = f"[mean]_{n_setups}_setups", model_name
    table.append(mean)


def write_log_file(table: Table, log_txt=None, log_xls=None) -> None:
    """Ref ``utils.py:687-694``: the table as CSV (floats ``%.4f``) and as
    ``.xlsx``."""
    if log_txt is not None:
        table.to_csv(log_txt, float_format="%.4f")
    if log_xls is not None:
        to_excel(table, log_xls, index=False)
    print(f"Log files are saved to {log_txt} and {log_xls}")


def read_log(filename: str) -> Table:
    """A comma-separated metrics log (ref ``utils.py:707-714``)."""
    return read_csv(filename, sep=",")


def log_to_table(filename: str) -> Table:
    """An old whitespace-separated (CompenNet-era) log file (ref
    ``utils.py:697-704``)."""
    return read_csv(filename, sep=r"\s+")


def export_setup_info(setup_path: str, cfg) -> None:
    """Write a setup's ``setup_info.yml`` (ref ``utils.py:656-670``)."""
    os.makedirs(setup_path, exist_ok=True)
    save_flat_yaml(cfg, join(setup_path, "setup_info.yml"))


def print_sys_info() -> None:
    """Ref ``utils.py:629-653``: the OS, torch, CUDA and the card."""
    import platform
    print("-" * 38 + " System info " + "-" * 39)
    print("OS:", platform.platform())
    print("torch version=" + torch.__version__
          + f", CUDA={torch.version.cuda}")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            print(f"cuda:{i}: {torch.cuda.get_device_name(i)}")
    else:
        print("devices: no CUDA device")
    print("-" * 38 + " System info " + "-" * 39)


def print_peak_memory(dev) -> None:
    """The process's peak device memory, for the caller's log."""
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"
            if dev.type == "cuda" else f"not measured on {dev.type}")
    print(f"[peak device memory] {peak}", flush=True)
