"""Pluggable metric sinks (port of ``aon_tpu/train/sinks.py``, pure Python as
there: the reference logs scalars + image grids to wandb, reference
``run.py:12,75`` and ``utils/train_helper.py:138-159``; here sinks are an
explicit seam).

Built-ins, selected via ``Config.metric_sinks`` (default
``["jsonl", "stdout"]`` plus wandb when ``WANDB_PROJECT`` is set):

* ``jsonl``       — one JSON record per log call (the committed-evidence
                    format every BASELINE.md row cites)
* ``stdout``      — human-readable progress lines
* ``tensorboard`` — scalar events in the standard ``events.out.tfevents``
                    format, written WITHOUT the tensorboard/TF packages
                    (hand-encoded protobuf + masked crc32c framing), so a
                    machine without those packages still produces TB logs
* ``wandb``       — forwards scalars/images when the package is importable

Third-party sinks: subclass :class:`Sink` and ``register_sink("name", cls)``.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Dict, Optional, Type

import numpy as np


class Sink:
    """One metrics destination.  ``rec`` always carries int ``step`` and
    float ``time`` (seconds since trainer start) plus metric floats."""

    def log_scalars(self, step: int, rec: Dict[str, object]) -> None:
        raise NotImplementedError

    def log_image(self, step: int, tag: str, path: str) -> None:
        """Called AFTER the image PNG is on disk; path is the file."""

    def close(self) -> None:
        pass


class JsonlSink(Sink):
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._fh = open(self.path, "a")

    def log_scalars(self, step: int, rec: Dict[str, object]) -> None:
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class StdoutSink(Sink):
    def __init__(self, logdir: str, every: int = 50):
        self.every = every

    def log_scalars(self, step: int, rec: Dict[str, object]) -> None:
        if rec.pop("_force_stdout", False) or (
            self.every and step % self.every == 0
        ):
            msg = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k != "time"
            )
            print(f"[{rec['time']:8.1f}s] {msg}", flush=True)


class WandbSink(Sink):
    """Active only when WANDB_PROJECT is set AND wandb imports; otherwise the
    sink is a no-op seam."""

    def __init__(self, logdir: str):
        self._wandb = None
        if os.environ.get("WANDB_PROJECT"):
            try:
                import wandb

                wandb.init(project=os.environ["WANDB_PROJECT"])
                self._wandb = wandb
            except ImportError:
                pass

    def log_scalars(self, step: int, rec: Dict[str, object]) -> None:
        if self._wandb is not None:
            self._wandb.log(rec, step=step)

    def log_image(self, step: int, tag: str, path: str) -> None:
        if self._wandb is not None:
            self._wandb.log({tag: self._wandb.Image(path)}, step=step)


# --------------------------------------------------------------- tensorboard
#
# Event-file writer with no tensorboard/TF dependency.  Format
# (tensorflow/core/lib/io/record_writer.cc): each record is
#   uint64le len | uint32le masked_crc32c(len bytes) | data
#   | uint32le masked_crc32c(data)
# where the payload is a serialized Event proto.  Only the fields TB's
# scalar dashboard reads are encoded: Event{wall_time=1(double),
# step=2(int64), file_version=3(string) | summary=5(msg)} and
# Summary{value=1(repeated msg)} / Summary.Value{tag=1(string),
# simple_value=2(float)}.

_CRC_TABLE = []


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _pb_string(num: int, s: bytes) -> bytes:
    return _field(num, 2) + _varint(len(s)) + s


def _pb_event(wall_time: float, step: int, *,
              file_version: Optional[str] = None,
              scalars: Optional[Dict[str, float]] = None) -> bytes:
    out = bytearray()
    out += _field(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _field(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        out += _pb_string(3, file_version.encode())
    if scalars:
        summary = bytearray()
        for tag, v in scalars.items():
            value = (_pb_string(1, tag.encode())
                     + _field(2, 5) + struct.pack("<f", float(v)))
            summary += _pb_string(1, bytes(value))
        out += _pb_string(5, bytes(summary))
    return bytes(out)


class TensorBoardSink(Sink):
    def __init__(self, logdir: str):
        tbdir = os.path.join(logdir, "tb")
        os.makedirs(tbdir, exist_ok=True)
        host = socket.gethostname()
        self.path = os.path.join(
            tbdir, f"events.out.tfevents.{int(time.time())}.{host}"
        )
        self._fh = open(self.path, "ab")
        self._write(_pb_event(time.time(), 0, file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(payload)
        self._fh.write(struct.pack("<I", _masked_crc(payload)))
        self._fh.flush()

    def log_scalars(self, step: int, rec: Dict[str, object]) -> None:
        scalars = {
            k: v for k, v in rec.items()
            if k not in ("step", "time") and isinstance(v, (int, float))
        }
        if scalars:
            self._write(_pb_event(time.time(), step, scalars=scalars))

    def close(self) -> None:
        self._fh.close()


_REGISTRY: Dict[str, Type[Sink]] = {
    "jsonl": JsonlSink,
    "stdout": StdoutSink,
    "tensorboard": TensorBoardSink,
    "wandb": WandbSink,
}


def register_sink(name: str, cls: Type[Sink]) -> None:
    _REGISTRY[name] = cls


def make_sink(name: str, logdir: str, **kw) -> Sink:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown metric sink {name!r}; known: {sorted(_REGISTRY)}"
        ) from None
    return cls(logdir, **kw)
