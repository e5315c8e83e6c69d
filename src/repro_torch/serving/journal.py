"""Crash-safe serving state: request journal + generation checkpoints
(DESIGN.md §18).

The guardrails give the fleet *detection* (sentinels, watchdogs, the
degradation ladder); this module gives it *recovery*.  Two durable
structures live side by side in one journal directory:

  * :class:`Journal` — an append-only, CRC-framed write-ahead log of
    request lifecycle events (``submitted`` / ``chunk`` / ``finished``
    / ``shed``).  Every record is ``<u32 length, u32 crc32>`` followed
    by a JSON payload; the recovery scan (:func:`scan_records`) stops
    at the first frame that fails its length or CRC check, so a crash
    mid-append costs exactly the torn final record and nothing before
    it.  The fsync policy is configurable (``always`` / ``interval`` /
    ``never``) because the durability/latency trade belongs to the
    operator, not the engine.  A clean shutdown writes a ``CLEAN``
    marker (tmp + fsync + ``os.replace`` via
    :mod:`repro_torch.utils.diskio`) carrying the last journal
    sequence number — recovery treats the state as crashed unless the
    marker exists *and* matches the scan, so a stale marker from a
    previous clean run never masks a later crash.

  * :class:`CheckpointStore` — a bounded on-disk store of per-request
    generation checkpoints ``(x_t, decision-cache state, step_offset,
    seed, bucket key)`` written at streaming chunk boundaries.  The
    chunked sampler contract (``step_offset``/``total_steps`` chaining
    is bitwise-equal to the monolithic run) is what makes these
    checkpoints *exact*: a warm restart or router failover that resumes
    from ``(x_t, dstate, step)`` replays the identical remaining
    schedule slice and lands on bitwise-identical final latents.  Array
    leaves (torch tensors or numpy arrays) are serialized as raw byte
    buffers with the dtype names numpy uses (``float32``, ``int32``,
    ``bfloat16``), encoded and decoded through torch, so ``bfloat16``
    needs no ``ml_dtypes`` and the files are the JAX package's byte for
    byte; :meth:`CheckpointStore.get` returns CPU tensors.  Each file
    is written atomically
    with a body CRC, and a corrupt or torn checkpoint degrades to
    replay-from-step-0 instead of an error — the checkpoint is an
    optimization, the journal is the source of truth.

:func:`recover` folds a journal directory into a
:class:`RecoveryState`: the pending request set (submitted, never
finished or shed), the latest delivered chunk per request, and the
clean/crashed verdict that ``launch/serve.py --resume`` acts on.

The on-disk formats are the JAX package's (``repro.serving.journal``):
a journal or checkpoint written by either package reads back in the
other.
"""

from __future__ import annotations

import ast
import base64
import dataclasses
import json
import os
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.diskio import atomic_write_bytes
from repro_torch.utils.logging import get_logger

log = get_logger("serve.journal")

__all__ = ["CheckpointStore", "Journal", "RecoveryState", "recover",
           "request_from_dict", "request_to_dict", "scan_records"]

# Frame header: payload length + payload crc32, little-endian u32 each.
_HDR = struct.Struct("<II")
# A length field beyond this is treated as frame corruption, not an
# instruction to allocate gigabytes.
_MAX_RECORD = 16 << 20

JOURNAL_FILE = "journal.log"
CLEAN_MARKER = "CLEAN"
FSYNC_POLICIES = ("always", "interval", "never")


def _torch_dtype(name: str) -> torch.dtype:
    """torch dtype from its saved (numpy-style) name: ``float32``,
    ``int32``, ``bool``, ``bfloat16``, ..."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown array dtype {name!r}")
    return dt


def _array_bytes(a) -> Tuple[List[int], str, bytes]:
    """``(shape, dtype name, raw bytes)`` of a torch tensor or numpy
    array, the name as numpy spells it (``torch.float32`` -> ``float32``),
    the bytes in C order."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        return (list(t.shape), str(t.dtype).rpartition(".")[2],
                t.reshape(-1).view(torch.uint8).numpy().tobytes())
    a = np.ascontiguousarray(np.asarray(a))
    return list(a.shape), a.dtype.name, a.tobytes()


def _array_from_bytes(buf: bytes, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor from its raw bytes (:func:`_array_bytes`' inverse)."""
    dt = _torch_dtype(dtype)
    flat = (torch.frombuffer(bytearray(buf), dtype=dt) if buf
            else torch.empty(0, dtype=dt))
    return flat.reshape(tuple(shape))


def _encode_array(a) -> Dict[str, Any]:
    shape, dtype, buf = _array_bytes(a)
    return {"shape": shape, "dtype": dtype,
            "b64": base64.b64encode(buf).decode("ascii")}


def _decode_array(d: Dict[str, Any]) -> torch.Tensor:
    return _array_from_bytes(base64.b64decode(d["b64"]), d["dtype"],
                             d["shape"])


# ---------------------------------------------------------------------------
# GenRequest <-> JSON (journal payload for `submitted` events)
# ---------------------------------------------------------------------------


def request_to_dict(req) -> Dict[str, Any]:
    """JSON-able snapshot of one
    :class:`~repro_torch.serving.engine.GenRequest`.  The ``resume`` /
    ``recovered`` runtime fields are deliberately excluded — they
    describe *this process's* serving attempt, not the request."""
    return {
        "request_id": int(req.request_id),
        "txt": _encode_array(req.txt),
        "steps": int(req.steps),
        "seed": int(req.seed),
        "guidance": float(req.guidance),
        "latent_shape": (None if req.latent_shape is None
                         else [int(d) for d in req.latent_shape]),
        "policy": req.policy,
        "reuse_every": (None if req.reuse_every is None
                        else int(req.reuse_every)),
        "deadline_s": (None if req.deadline_s is None
                       else float(req.deadline_s)),
        "stream_every": (None if req.stream_every is None
                         else int(req.stream_every)),
    }


def request_from_dict(d: Dict[str, Any]):
    """Rebuild the :class:`~repro_torch.serving.engine.GenRequest` a
    ``submitted`` journal event recorded.  The absolute ``deadline_s``
    is carried verbatim — recovery callers that resubmit after a
    restart strip it (it has almost certainly expired, and shedding a
    journaled request at the recovery door would violate the
    every-journaled-request-completes contract).  ``txt`` comes back as
    the numpy array the engine takes."""
    from repro_torch.serving.engine import GenRequest

    return GenRequest(
        request_id=int(d["request_id"]),
        txt=_decode_array(d["txt"]).numpy(),
        steps=int(d["steps"]),
        seed=int(d["seed"]),
        guidance=float(d["guidance"]),
        latent_shape=(None if d["latent_shape"] is None
                      else tuple(d["latent_shape"])),
        policy=d["policy"],
        reuse_every=d["reuse_every"],
        deadline_s=d["deadline_s"],
        stream_every=d["stream_every"],
    )


# ---------------------------------------------------------------------------
# The write-ahead journal
# ---------------------------------------------------------------------------


def scan_records(path: str) -> Tuple[List[Dict[str, Any]], bool]:
    """Read every intact record of a journal file, in order.  Returns
    ``(records, torn)`` where ``torn`` means the file ends in a frame
    that fails its length/CRC/JSON check — expected after a crash
    mid-append, never an error: everything before the torn frame is
    trusted, nothing after it is read."""
    records: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return records, False
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        if off + _HDR.size > len(data):
            return records, True
        length, crc = _HDR.unpack_from(data, off)
        if length > _MAX_RECORD or off + _HDR.size + length > len(data):
            return records, True
        payload = data[off + _HDR.size: off + _HDR.size + length]
        if zlib.crc32(payload) != crc:
            return records, True
        try:
            records.append(json.loads(payload.decode("utf-8")))
        except (UnicodeDecodeError, json.JSONDecodeError):
            return records, True
        off += _HDR.size + length
    return records, False


class Journal:
    """Append-only request-lifecycle WAL (module docstring).  Opening a
    journal removes any clean-shutdown marker — the process is running
    now, so the state on disk is by definition no longer a clean
    snapshot until :meth:`close` says so again.  Thread-safe; every
    append is flushed to the OS before returning (a SIGKILL can then
    tear at most the record an OS/power crash could — which the scan
    tolerates)."""

    def __init__(self, dirpath: str, *, fsync: str = "always",
                 fsync_interval: int = 8,
                 time_fn: Callable[[], float] = time.time):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync policy must be one of "
                             f"{FSYNC_POLICIES}, got {fsync!r}")
        os.makedirs(dirpath, exist_ok=True)
        self.dir = dirpath
        self.path = os.path.join(dirpath, JOURNAL_FILE)
        self.fsync_policy = fsync
        self.fsync_interval = max(int(fsync_interval), 1)
        self._time = time_fn
        # Continue the sequence after whatever the existing log holds —
        # a torn tail is fine, we append after the last *intact* frame.
        records, torn = scan_records(self.path)
        self._seq = records[-1]["seq"] if records else 0
        valid = 0
        if records:
            with open(self.path, "rb") as f:
                data = f.read()
            off = 0
            for _ in records:
                length, _crc = _HDR.unpack_from(data, off)
                off += _HDR.size + length
            valid = off
        if torn:
            log.warning("journal %s has a torn tail; truncating to %d "
                        "intact record(s)", self.path, len(records))
        self._f = open(self.path, "ab")
        if torn and self._f.tell() > valid:
            self._f.truncate(valid)
        # Running again: the on-disk state is live, not a clean snapshot.
        marker = os.path.join(dirpath, CLEAN_MARKER)
        if os.path.exists(marker):
            os.unlink(marker)
        self._lock = threading.Lock()
        self._appends_since_fsync = 0
        self.appends = 0
        self.bytes_written = 0
        self.fsyncs = 0
        self.fsync_ms = 0.0
        self._closed = False

    # -- append path -------------------------------------------------------

    def append(self, event: str, rid: int, **fields) -> int:
        """Append one lifecycle record; returns its sequence number."""
        with self._lock:
            if self._closed:
                raise RuntimeError("journal is closed")
            self._seq += 1
            rec = {"seq": self._seq, "ev": event, "rid": int(rid)}
            rec.update(fields)
            payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
            self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
            self._f.write(payload)
            self._f.flush()
            self.appends += 1
            self.bytes_written += _HDR.size + len(payload)
            self._appends_since_fsync += 1
            if self.fsync_policy == "always" or (
                    self.fsync_policy == "interval"
                    and self._appends_since_fsync >= self.fsync_interval):
                self._fsync_locked()
            return self._seq

    def _fsync_locked(self):
        t0 = time.perf_counter()
        os.fsync(self._f.fileno())
        self.fsync_ms += (time.perf_counter() - t0) * 1e3
        self.fsyncs += 1
        self._appends_since_fsync = 0

    # -- lifecycle convenience wrappers ------------------------------------

    def record_submitted(self, req) -> int:
        return self.append("submitted", req.request_id,
                           req=request_to_dict(req))

    def record_chunk(self, rid: int, chunk: int,
                     step: Optional[int] = None) -> int:
        return self.append("chunk", rid, chunk=int(chunk),
                           step=None if step is None else int(step))

    def record_finished(self, rid: int, error: Optional[str] = None) -> int:
        return self.append("finished", rid, error=error)

    def record_shed(self, rid: int, reason: str = "") -> int:
        return self.append("shed", rid, reason=str(reason))

    # -- shutdown ----------------------------------------------------------

    def close(self, clean: bool = True):
        """Flush + fsync the log; with ``clean`` also write the
        clean-shutdown marker stamping the final sequence number, so
        the next :func:`recover` can tell a graceful drain from a
        crash.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._f.flush()
            if self.fsync_policy != "never":
                self._fsync_locked()
            self._f.close()
            if clean:
                atomic_write_bytes(
                    os.path.join(self.dir, CLEAN_MARKER),
                    json.dumps({"last_seq": self._seq,
                                "time": self._time()}).encode("utf-8"),
                    fsync=self.fsync_policy != "never")

    def metrics(self) -> Dict[str, float]:
        with self._lock:
            return {"journal_appends": self.appends,
                    "journal_bytes": self.bytes_written,
                    "journal_fsyncs": self.fsyncs,
                    "journal_fsync_ms": self.fsync_ms}


# ---------------------------------------------------------------------------
# Recovery
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RecoveryState:
    """What a journal directory says happened (:func:`recover`)."""

    clean: bool                      # clean-shutdown marker matched the scan
    torn: bool                       # the log ended in a torn frame
    last_seq: int
    events: int
    # rid -> request dict (latest `submitted`, never finished/shed)
    pending: Dict[int, Dict[str, Any]]
    # rid -> {"chunk": int, "step": Optional[int]} latest delivered chunk
    chunks: Dict[int, Dict[str, Any]]
    finished: Dict[int, Optional[str]]   # rid -> error (None = success)
    shed: Dict[int, str]                 # rid -> shed reason


def recover(dirpath: str) -> RecoveryState:
    """Fold the journal into the sets a warm restart needs.  Event
    order is authoritative: a request is *pending* iff its latest
    ``submitted`` record has no later ``finished``/``shed`` record.
    Clean means the marker exists, parses, and stamps exactly the last
    intact sequence number — a marker from an older clean run followed
    by more journal records is a crash, not a clean shutdown."""
    path = os.path.join(dirpath, JOURNAL_FILE)
    records, torn = scan_records(path)
    pending: Dict[int, Dict[str, Any]] = {}
    chunks: Dict[int, Dict[str, Any]] = {}
    finished: Dict[int, Optional[str]] = {}
    shed: Dict[int, str] = {}
    last_seq = records[-1]["seq"] if records else 0
    for rec in records:
        rid = rec.get("rid")
        ev = rec.get("ev")
        if ev == "submitted":
            pending[rid] = rec.get("req", {})
            finished.pop(rid, None)
            shed.pop(rid, None)
        elif ev == "chunk":
            chunks[rid] = {"chunk": rec.get("chunk"),
                           "step": rec.get("step")}
        elif ev == "finished":
            pending.pop(rid, None)
            finished[rid] = rec.get("error")
        elif ev == "shed":
            pending.pop(rid, None)
            shed[rid] = rec.get("reason", "")
    clean = not torn
    marker = os.path.join(dirpath, CLEAN_MARKER)
    if os.path.exists(marker):
        try:
            with open(marker, "r", encoding="utf-8") as f:
                m = json.load(f)
            clean = clean and int(m.get("last_seq", -1)) == last_seq
        except (OSError, ValueError):
            clean = False
    else:
        # No marker: clean only in the trivial no-journal case.
        clean = clean and not records and not os.path.exists(path)
    return RecoveryState(clean=clean, torn=torn, last_seq=last_seq,
                         events=len(records), pending=pending,
                         chunks=chunks, finished=finished, shed=shed)


# ---------------------------------------------------------------------------
# Chunk-boundary generation checkpoints
# ---------------------------------------------------------------------------


class CheckpointStore:
    """Bounded per-request checkpoint files under ``<dir>/ckpt/``.

    One file per request id, overwritten at every chunk boundary with
    the latest ``(x_t, decision-cache arrays, step, seed, bucket)``
    snapshot; :meth:`discard` removes it when the request finishes, so
    steady state holds only in-flight work.  ``max_entries`` bounds the
    pathological case (a flood of abandoned requests): the
    least-recently-written id is evicted first.  Writes are atomic
    (tmp + optional fsync + replace) and the body carries a CRC — a
    torn or corrupt file makes :meth:`get` return ``None`` (resume
    degrades to replay-from-0) rather than raise."""

    def __init__(self, dirpath: str, *, max_entries: int = 64,
                 fsync: bool = True):
        self.dir = os.path.join(dirpath, "ckpt")
        os.makedirs(self.dir, exist_ok=True)
        self.max_entries = max(int(max_entries), 1)
        self.fsync = fsync
        self._lock = threading.Lock()
        # rid -> path, in least-recently-written order (existing files
        # re-adopted oldest-mtime-first so restarts keep the bound).
        self._files: "Dict[int, str]" = {}
        try:
            names = [(os.path.getmtime(os.path.join(self.dir, n)), n)
                     for n in os.listdir(self.dir)
                     if n.startswith("ckpt_") and n.endswith(".bin")]
        except OSError:
            names = []
        for _, n in sorted(names):
            try:
                rid = int(n[len("ckpt_"):-len(".bin")])
            except ValueError:
                continue
            self._files[rid] = os.path.join(self.dir, n)
        self.writes = 0
        self.bytes_written = 0
        self.write_ms = 0.0

    def _path(self, rid: int) -> str:
        return os.path.join(self.dir, f"ckpt_{int(rid)}.bin")

    def put(self, rid: int, *, step: int, x, seed: int,
            bucket: Any = None, dstate: Optional[Dict[str, Any]] = None):
        """Persist the latest checkpoint for ``rid``.  ``x`` and the
        leaves of ``dstate`` are torch tensors (any device) or numpy
        arrays; ``dstate`` is the field-name -> array mapping of one
        request's layer-stacked decision state (the keys of
        :class:`repro_torch.core.decision_cache.CachedDecision`; None
        for samplers that thread no cache)."""
        t0 = time.perf_counter()
        shape, dtype, xbuf = _array_bytes(x)
        bufs = [xbuf]
        meta: Dict[str, Any] = {
            "rid": int(rid), "step": int(step), "seed": int(seed),
            "bucket": repr(bucket),
            "x": {"shape": shape, "dtype": dtype, "len": len(xbuf)},
            "dstate": None,
        }
        if dstate is not None:
            dmeta: Dict[str, Any] = {}
            for name, arr in dstate.items():
                if arr is None:
                    dmeta[name] = None
                    continue
                shape, dtype, buf = _array_bytes(arr)
                bufs.append(buf)
                dmeta[name] = {"shape": shape, "dtype": dtype,
                               "len": len(buf)}
            meta["dstate"] = dmeta
        blob = b"".join(bufs)
        meta["crc"] = zlib.crc32(blob)
        header = json.dumps(meta, separators=(",", ":")).encode("utf-8")
        body = struct.pack("<I", len(header)) + header + blob
        path = self._path(rid)
        atomic_write_bytes(path, body, fsync=self.fsync)
        with self._lock:
            self._files.pop(rid, None)   # re-insert as most recent
            self._files[rid] = path
            evict = []
            while len(self._files) > self.max_entries:
                old_rid = next(iter(self._files))
                evict.append(self._files.pop(old_rid))
            self.writes += 1
            self.bytes_written += len(body)
            self.write_ms += (time.perf_counter() - t0) * 1e3
        for p in evict:
            try:
                os.unlink(p)
            except OSError:
                pass

    def get(self, rid: int) -> Optional[Dict[str, Any]]:
        """Latest checkpoint for ``rid`` as ``{"step", "seed",
        "bucket", "x", "dstate"}`` with decoded CPU tensors, or ``None``
        when absent/corrupt (resume then replays from step 0)."""
        path = self._path(rid)
        try:
            with open(path, "rb") as f:
                body = f.read()
        except OSError:
            return None
        try:
            if len(body) < 4:
                raise ValueError("truncated header length")
            (hlen,) = struct.unpack_from("<I", body, 0)
            header = body[4:4 + hlen]
            meta = json.loads(header.decode("utf-8"))
            blob = body[4 + hlen:]
            if zlib.crc32(blob) != meta["crc"]:
                raise ValueError("checkpoint body CRC mismatch")
            off = 0

            def take(m):
                nonlocal off
                buf = blob[off:off + m["len"]]
                if len(buf) != m["len"]:
                    raise ValueError("truncated checkpoint buffer")
                off += m["len"]
                return _array_from_bytes(buf, m["dtype"], m["shape"])

            out: Dict[str, Any] = {"step": int(meta["step"]),
                                   "seed": int(meta["seed"]),
                                   "x": take(meta["x"]), "dstate": None}
            try:
                out["bucket"] = ast.literal_eval(meta.get("bucket", "None"))
            except (ValueError, SyntaxError):
                out["bucket"] = None
            if meta.get("dstate") is not None:
                out["dstate"] = {
                    name: (None if m is None else take(m))
                    for name, m in meta["dstate"].items()}
            return out
        except (ValueError, KeyError, TypeError, RuntimeError,
                json.JSONDecodeError, struct.error) as e:
            log.warning("checkpoint for request %d unreadable (%s); "
                        "resume will replay from step 0", rid, e)
            return None

    def discard(self, rid: int):
        """Drop the checkpoint for a finished request (idempotent)."""
        with self._lock:
            path = self._files.pop(rid, self._path(rid))
        try:
            os.unlink(path)
        except OSError:
            pass

    def count(self) -> int:
        with self._lock:
            return len(self._files)

    def rids(self) -> List[int]:
        with self._lock:
            return list(self._files)

    def metrics(self) -> Dict[str, float]:
        with self._lock:
            return {"checkpoint_writes": self.writes,
                    "checkpoint_bytes": self.bytes_written,
                    "checkpoint_write_ms": self.write_ms}
