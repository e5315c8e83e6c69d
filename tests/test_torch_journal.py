"""The port's crash-safety files (DESIGN.md §18) against the JAX
package's, on the CPU: the journal's frames and clean-shutdown marker
byte for byte for the same events, ``recover`` at every byte offset of a
torn log, the clean / crashed verdicts, and chunk checkpoints (a bf16
decision-state leaf included) written by one package and read by the
other, with corruption, bounded eviction, ``discard`` and re-adoption
at restart behaving alike."""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # fixed examples instead of properties
    from _hypothesis_compat import given, settings, st

from repro.serving import engine as j_engine  # noqa: E402
from repro.serving import journal as j_journal  # noqa: E402
from repro_torch.serving import engine as engine_lib  # noqa: E402
from repro_torch.serving import journal  # noqa: E402

PKGS = {"jax": (j_journal, j_engine.GenRequest),
        "port": (journal, engine_lib.GenRequest)}
CLOCK = 1234.5

# Lifecycle events: (kind, args); a submitted event's args are the
# request's fields.
EVENTS = [
    ("submitted", dict(request_id=0, steps=4, seed=3, stream_every=2,
                       policy="ripple", reuse_every=2, guidance=2.5,
                       deadline_s=1700000000.25)),
    ("submitted", dict(request_id=1, steps=6, seed=4)),
    ("chunk", (0, 0, 2)),
    ("chunk", (1, 0, None)),
    ("finished", (0, None)),
    ("shed", (2, "request 2 shed: deadline passed")),
    ("finished", (1, "RuntimeError('injected poison fault: request 1')")),
    ("submitted", dict(request_id=5, steps=3, latent_shape=(4, 8, 8, 4))),
]


def _request(pkg, fields):
    fields = dict(fields)
    rid = fields["request_id"]
    fields.setdefault("latent_shape", (4,))
    txt = (np.arange(6, dtype=np.float32).reshape(2, 3) + rid) / 7.0
    return PKGS[pkg][1](txt=txt, **fields)


def _write(pkg, d, events=EVENTS, *, fsync="always", clean=True):
    """Write ``events`` through ``pkg``'s journal into ``d``; returns
    the journal's metrics."""
    j = PKGS[pkg][0].Journal(d, fsync=fsync, fsync_interval=2,
                             time_fn=lambda: CLOCK)
    for kind, args in events:
        if kind == "submitted":
            j.record_submitted(_request(pkg, args))
        else:
            getattr(j, f"record_{kind}")(*args)
    m = j.metrics()
    j.close(clean=clean)
    return m


def _read(path):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()


def _verdict(pkg, d):
    return dataclasses.asdict(PKGS[pkg][0].recover(d))


# ---------------------------------------------------------------------------
# The journal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clean", [True, False], ids=["clean", "crash"])
@pytest.mark.parametrize("fsync", ["always", "interval", "never"])
def test_journal_bytes_equal_the_reference(tmp_path, fsync, clean):
    """The same events with a frozen clock give the same journal.log and
    CLEAN bytes (or no marker in both), and the same counts."""
    metrics = {}
    for pkg in PKGS:
        metrics[pkg] = _write(pkg, str(tmp_path / pkg), fsync=fsync,
                              clean=clean)
    for name in (journal.JOURNAL_FILE, journal.CLEAN_MARKER):
        got, want = (_read(str(tmp_path / pkg / name))
                     for pkg in ("port", "jax"))
        assert got == want, name
    assert (_read(str(tmp_path / "port" / "CLEAN")) is not None) == clean
    for m in metrics.values():
        m.pop("journal_fsync_ms")
    assert metrics["port"] == metrics["jax"]
    assert metrics["port"]["journal_appends"] == len(EVENTS)


@settings(max_examples=10, deadline=None)
@given(n=st.integers(1, 12), rid0=st.integers(0, 999))
def test_random_appends_frame_alike(n, rid0):
    """Property: any run of appends frames byte for byte alike, and each
    package scans the other's log back intact, in order."""
    with tempfile.TemporaryDirectory() as tmp:
        for pkg, (mod, _) in PKGS.items():
            j = mod.Journal(os.path.join(tmp, pkg), fsync="never")
            for i in range(n):
                ev = ("submitted", "chunk", "finished", "shed")[i % 4]
                j.append(ev, rid0 + i, i=i, pad="x" * i)
            j.close(clean=False)
        paths = {pkg: os.path.join(tmp, pkg, journal.JOURNAL_FILE)
                 for pkg in PKGS}
        assert _read(paths["port"]) == _read(paths["jax"])
        records, torn = journal.scan_records(paths["jax"])
        assert (records, torn) == j_journal.scan_records(paths["port"])
        assert not torn and [r["seq"] for r in records] == \
            list(range(1, n + 1))
        assert [r["rid"] for r in records] == list(range(rid0, rid0 + n))


def test_torn_tail_recovers_alike_at_every_offset(tmp_path):
    """A log cut at every byte offset gives the same RecoveryState from
    both packages: every whole record before the cut, a torn flag
    exactly when the cut is inside a frame."""
    d = str(tmp_path / "torn")
    _write("port", d, clean=False)
    path = os.path.join(d, journal.JOURNAL_FILE)
    data = _read(path)
    ends, off = [], 0
    while off < len(data):
        off += 8 + int(np.frombuffer(data[off:off + 4], np.uint32)[0])
        ends.append(off)
    for cut in range(len(data) + 1):
        with open(path, "wb") as f:
            f.write(data[:cut])
        got = _verdict("port", d)
        assert got == _verdict("jax", d), cut
        assert got["events"] == sum(e <= cut for e in ends)
        assert got["torn"] == (cut not in [0] + ends)
        assert not got["clean"]


@pytest.mark.parametrize("where", [0, 4, 12], ids=["length", "crc",
                                                   "payload"])
def test_corrupt_middle_record_stops_the_scan_alike(tmp_path, where):
    d = str(tmp_path / "mid")
    _write("port", d, clean=False)
    path = os.path.join(d, journal.JOURNAL_FILE)
    data = bytearray(_read(path))
    second = 8 + int(np.frombuffer(bytes(data[:4]), np.uint32)[0])
    data[second + where] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    got = journal.scan_records(path)
    assert got == j_journal.scan_records(path)
    records, torn = got
    assert torn and [r["seq"] for r in records] == [1]


def test_reopen_truncates_a_torn_tail_and_continues_alike(tmp_path):
    """Reopening a log that ends in a torn frame truncates the frame and
    continues the sequence; both packages leave the same bytes."""
    for pkg, (mod, _) in PKGS.items():
        d = str(tmp_path / pkg)
        _write(pkg, d, EVENTS[:3], clean=False)
        with open(os.path.join(d, journal.JOURNAL_FILE), "ab") as f:
            f.write(b"\x99\x00\x00\x00garbage")
        j = mod.Journal(d, fsync="never", time_fn=lambda: CLOCK)
        assert j.append("finished", 0) == 4
        j.close(clean=True)
    got, want = (_read(str(tmp_path / pkg / journal.JOURNAL_FILE))
                 for pkg in ("port", "jax"))
    assert got == want
    records, torn = journal.scan_records(
        str(tmp_path / "port" / journal.JOURNAL_FILE))
    assert not torn and [r["ev"] for r in records] == \
        ["submitted", "submitted", "chunk", "finished"]
    assert _verdict("port", str(tmp_path / "port"))["clean"]


def _marker_case(pkg, d, case):
    """Leave ``d`` as a clean close, a crash, a stale marker (an older
    clean run's marker put back after more records) or nothing."""
    if case == "empty":
        return
    mod = PKGS[pkg][0]
    _write(pkg, d, EVENTS[:2], clean=True)
    if case == "clean":
        return
    stale = _read(os.path.join(d, journal.CLEAN_MARKER))
    j = mod.Journal(d, time_fn=lambda: CLOCK)
    assert not os.path.exists(os.path.join(d, journal.CLEAN_MARKER))
    j.record_submitted(_request(pkg, EVENTS[7][1]))
    j._f.close()  # the process dies: no close(), no marker
    if case == "stale":
        with open(os.path.join(d, journal.CLEAN_MARKER), "wb") as f:
            f.write(stale)


@pytest.mark.parametrize("case,clean,pending", [
    ("clean", True, [0, 1]), ("crash", False, [0, 1, 5]),
    ("stale", False, [0, 1, 5]), ("empty", True, [])])
def test_clean_marker_verdicts_agree(tmp_path, case, clean, pending):
    """Each package's directory gets the same verdict from both
    packages: clean only with a marker stamping the last record (or no
    journal at all)."""
    verdicts = []
    for writer in PKGS:
        d = str(tmp_path / writer)
        _marker_case(writer, d, case)
        for reader in PKGS:
            verdicts.append(_verdict(reader, d))
    assert all(v == verdicts[0] for v in verdicts[1:])
    assert verdicts[0]["clean"] == clean
    assert sorted(verdicts[0]["pending"]) == pending
    if case == "clean":
        assert json.loads(_read(str(tmp_path / "port" / "CLEAN"))) == \
            {"last_seq": 2, "time": CLOCK}


def test_requests_round_trip_across_packages():
    """A request journaled by either package comes back in the other
    with its fields and text embedding; the run-time fields (resume,
    recovered) are not journaled."""
    fields = dict(EVENTS[0][1], latent_shape=(4, 8, 8, 4))
    for src, dst in (("jax", "port"), ("port", "jax")):
        req = _request(src, fields)
        req.resume = {"step": 2, "x": np.zeros(4, np.float32)}
        req.recovered = True
        d = json.loads(json.dumps(PKGS[src][0].request_to_dict(req)))
        assert d == PKGS[dst][0].request_to_dict(_request(dst, fields))
        back = PKGS[dst][0].request_from_dict(d)
        assert back.resume is None and not back.recovered
        for name in ("request_id", "steps", "seed", "guidance",
                     "latent_shape", "policy", "reuse_every", "deadline_s",
                     "stream_every"):
            assert getattr(back, name) == getattr(req, name), name
        np.testing.assert_array_equal(np.asarray(back.txt), req.txt)


# ---------------------------------------------------------------------------
# Chunk checkpoints
# ---------------------------------------------------------------------------

BUCKET = ((4, 8, 8, 4), 12, "ripple", 4, 1, (8, 64), 4, None)


def _ckpt_arrays():
    """numpy arrays for the JAX package (bf16 through ml_dtypes) and the
    same bits as tensors for the port."""
    x = (np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4) - 5) / 7
    bias = np.asarray(jnp.asarray(np.linspace(-3, 3, 24).reshape(
        2, 1, 3, 4), jnp.bfloat16))
    arrays = {"q_idx": np.arange(2 * 1 * 3 * 2, dtype=np.int32).reshape(
                  2, 1, 3, 2),
              "bias": bias, "block_map": None,
              "ref_stat": np.full((2, 1, 3), 0.375, np.float32),
              "hits": np.ones((2, 1, 3), np.int32)}
    tensors = {k: None if v is None else torch.from_numpy(
        v.view(np.int16).copy()).view(torch.bfloat16)
        if v.dtype.name == "bfloat16" else torch.from_numpy(v.copy())
        for k, v in arrays.items()}
    return x, arrays, tensors


def _bits(a):
    """A leaf's raw bits as a numpy array, bf16 included."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_packages_bit_equal(tmp_path, writer):
    """A checkpoint with a bf16 decision-state leaf, written by either
    package, reads back bit-equal in the other (the port as CPU
    tensors, dtype names as numpy spells them), and both write the same
    file for the same arrays."""
    x, arrays, tensors = _ckpt_arrays()
    files = {}
    for pkg, (mod, _) in PKGS.items():
        store = mod.CheckpointStore(str(tmp_path / pkg))
        if pkg == "port":
            store.put(3, step=4, x=torch.from_numpy(x), seed=11,
                      bucket=BUCKET, dstate=tensors)
        else:
            store.put(3, step=4, x=x, seed=11, bucket=BUCKET, dstate=arrays)
        files[pkg] = _read(store._path(3))
    assert files["port"] == files["jax"]
    reader = "port" if writer == "jax" else "jax"
    ck = PKGS[reader][0].CheckpointStore(str(tmp_path / writer)).get(3)
    assert (ck["step"], ck["seed"], ck["bucket"]) == (4, 11, BUCKET)
    np.testing.assert_array_equal(_bits(ck["x"]), x)
    assert set(ck["dstate"]) == set(arrays)
    for name, want in arrays.items():
        got = ck["dstate"][name]
        if want is None:
            assert got is None
            continue
        assert str(got.dtype).rpartition(".")[2] == want.dtype.name
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("damage", ["body", "header_length", "header_json",
                                    "absent"])
def test_corrupt_checkpoints_read_as_none_alike(tmp_path, damage):
    store = journal.CheckpointStore(str(tmp_path))
    store.put(1, step=1, x=torch.zeros(4), seed=0)
    path = store._path(1)
    data = bytearray(_read(path))
    if damage == "body":
        data[-3:] = b"\xff\xff\xff"
    elif damage == "header_length":
        data = data[:1]
    elif damage == "header_json":
        data[5] ^= 0xFF
    if damage == "absent":
        os.unlink(path)
    else:
        with open(path, "wb") as f:
            f.write(bytes(data))
    assert store.get(1) is None
    assert j_journal.CheckpointStore(str(tmp_path)).get(1) is None


def test_bounded_eviction_discard_and_readoption_alike(tmp_path):
    """The same puts and discards leave the same ids in both stores,
    least recently written evicted first; a store opened on a directory
    adopts its files in the same order in both packages."""
    stores = {pkg: mod.CheckpointStore(str(tmp_path / pkg), max_entries=2)
              for pkg, (mod, _) in PKGS.items()}
    ops = [("put", 0), ("put", 1), ("put", 2), ("put", 3), ("discard", 3),
           ("discard", 3), ("put", 4), ("put", 2), ("put", 5)]
    for op, rid in ops:
        for pkg, store in stores.items():
            if op == "put":
                x = (torch.full((2,), float(rid)) if pkg == "port"
                     else np.full(2, rid, np.float32))
                store.put(rid, step=1, x=x, seed=rid)
            else:
                store.discard(rid)
        assert stores["port"].rids() == stores["jax"].rids()
    assert stores["port"].rids() == [2, 5]
    assert stores["port"].get(0) is None
    assert not os.path.exists(stores["port"]._path(0))
    m = {pkg: s.metrics() for pkg, s in stores.items()}
    for pkg in m:
        m[pkg].pop("checkpoint_write_ms")
    assert m["port"] == m["jax"]
    for d in ("port", "jax"):
        again = {pkg: mod.CheckpointStore(str(tmp_path / d), max_entries=8)
                 for pkg, (mod, _) in PKGS.items()}
        assert again["port"].rids() == again["jax"].rids()
        assert sorted(again["port"].rids()) == [2, 5]
        assert float(again["port"].get(5)["x"][0]) == 5.0
