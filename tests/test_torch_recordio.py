"""PyTorch port vs the JAX package: RecordIO on the CPU.

Files written by the port's writers (one record at a time, and the batched
write through the native framing or, with ``DMLC_TPU_DISABLE_NATIVE``, the
numpy path) must be byte-identical to the JAX writers' output, with
in-band magic words and empty records among the payloads.  Readers and the
chunk scan of both engines must give back the JAX package's records, and
bad framing must be refused with the engine's own error.
"""

import struct

import numpy as np
import pytest

from dmlc_core_tpu.io import memory_io as jmem
from dmlc_core_tpu.io import recordio as jrio
from dmlc_core_tpu_torch import native_bridge as nb
from dmlc_core_tpu_torch.io import memory_io as pmem
from dmlc_core_tpu_torch.io import recordio as prio
from tests.test_torch_native import jax_python_engine, use_engine  # noqa: F401

MAGIC = struct.pack("<I", 0xCED7230A)
SEEDS = (0, 1, 2)
WRITES = ("write_record", "write_records-native", "write_records-numpy")


def make_records(seed, n=300):
    """Payloads of 0-80 bytes; some hold the magic word at 4-aligned and
    unaligned offsets (the escape path), some are empty."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        parts = []
        for _ in range(rng.randint(0, 20)):
            r = rng.rand()
            if r < 0.15:
                parts.append(MAGIC)
            elif r < 0.2:
                parts.append(b"\x0a" + MAGIC[:3])
            else:
                parts.append(rng.bytes(rng.randint(1, 5)))
        out.append(b"".join(parts))
    out[::37] = [b""] * len(out[::37])
    return out


def write_port(records, how, monkeypatch, indexed=False):
    cls = prio.IndexedRecordIOWriter if indexed else prio.RecordIOWriter
    stream = pmem.MemoryStringStream()
    writer = cls(stream)
    if how == "write_record":
        for rec in records:
            writer.write_record(rec)
    else:
        use_engine(monkeypatch, how.split("-")[1])
        half = len(records) // 2
        writer.write_records(records[:half])
        writer.write_records(records[half:])
        calls = nb.ENGINE_CALLS["recordio_frame"]
        assert calls == (2 if how.endswith("native") else 0)
    return writer, bytes(stream.data)


def write_jax(records, indexed=False):
    cls = jrio.IndexedRecordIOWriter if indexed else jrio.RecordIOWriter
    stream = jmem.MemoryStringStream()
    writer = cls(stream)
    for rec in records:
        writer.write_record(rec)
    return writer, bytes(stream.data)


@pytest.mark.parametrize("how", WRITES)
@pytest.mark.parametrize("seed", SEEDS)
def test_writer_bytes_identical_to_jax(monkeypatch, seed, how):
    records = make_records(seed)
    pw, got = write_port(records, how, monkeypatch)
    jw, want = write_jax(records)
    assert got == want
    assert pw.except_counter == jw.except_counter > 0


@pytest.mark.parametrize("how", WRITES)
def test_indexed_writer_offsets_and_index_identical(monkeypatch, how):
    records = make_records(5, n=200)
    pw, got = write_port(records, how, monkeypatch, indexed=True)
    jw, want = write_jax(records, indexed=True)
    assert got == want
    assert pw.offsets == jw.offsets
    pidx, jidx = pmem.MemoryStringStream(), jmem.MemoryStringStream()
    pw.save_index(pidx)
    jw.save_index(jidx)
    assert bytes(pidx.data) == bytes(jidx.data)


@pytest.mark.parametrize("seed", SEEDS)
def test_reader_reads_back_what_jax_wrote(seed):
    records = make_records(seed)
    _, blob = write_jax(records)
    got = list(prio.RecordIOReader(pmem.MemoryStringStream(bytearray(blob))))
    assert got == records
    assert got == list(jrio.RecordIOReader(
        jmem.MemoryStringStream(bytearray(blob))))


@pytest.mark.parametrize("engine", ("native", "numpy"))
@pytest.mark.parametrize("nparts", (1, 2, 3, 4))
def test_chunk_reader_parts_match_jax_python_engine(monkeypatch,
                                                    jax_python_engine,
                                                    nparts, engine):
    records = make_records(7)
    _, blob = write_jax(records)
    use_engine(monkeypatch, engine)
    every = []
    for part in range(nparts):
        got = [bytes(r) for r in prio.RecordIOChunkReader(blob, part, nparts)]
        want = [bytes(r) for r in jrio.RecordIOChunkReader(blob, part,
                                                           nparts)]
        assert got == want
        every += got
    assert every == records
    assert (nb.ENGINE_CALLS["recordio_scan"] == nparts) == (engine == "native")


_GOOD = MAGIC + struct.pack("<I", 5) + b"hello\0\0\0"
_BAD = {
    # a head whose length runs past the chunk
    "truncated record": MAGIC + struct.pack("<I", 64) + b"abcd",
    # an escaped record whose next part is not a continuation
    "bad continuation cflag": (MAGIC + struct.pack("<I", (1 << 29) | 4)
                               + b"abcd" + _GOOD),
    # an escaped record cut off before its last part
    "truncated escaped record": MAGIC + struct.pack("<I", (1 << 29) | 4)
    + b"abcd",
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_scan_rejects_bad_framing_like_the_reference(monkeypatch,
                                                     jax_python_engine,
                                                     case):
    blob = _GOOD + _BAD[case]
    with pytest.raises(ValueError,
                       match=f"^invalid RecordIO format: {case}$"):
        nb.recordio_scan(blob, 0, len(blob))
    use_engine(monkeypatch, "native")
    with pytest.raises(ValueError, match=case):
        list(prio.RecordIOChunkReader(blob))
    # the numpy engine refuses it as the JAX package's Python engine does
    use_engine(monkeypatch, "numpy")
    with pytest.raises(Exception, match="invalid RecordIO format") as port:
        list(prio.RecordIOChunkReader(blob))
    with pytest.raises(Exception, match="invalid RecordIO format") as jax:
        list(jrio.RecordIOChunkReader(blob))
    # the same message; its [file:line] prefix names each package's line
    assert (str(port.value).split("] ", 1)[1]
            == str(jax.value).split("] ", 1)[1])


def test_scan_rejects_unaligned_bounds():
    with pytest.raises(ValueError, match="invalid scan bounds"):
        nb.recordio_scan(_GOOD, 2, len(_GOOD))


def test_scan_skips_garbage_before_the_first_head():
    """Bytes before the first head (magic + cflag 0/1) are skipped, as a
    split that starts mid-file resyncs."""
    blob = b"\x01\x02\x03\x04" + MAGIC + struct.pack("<I", 7 << 29) + _GOOD
    head, plen, escaped, pbegin, pend = nb.recordio_scan(blob, 0, len(blob))
    assert (pbegin, pend) == (12, len(blob))
    assert head.tolist() == [12] and plen.tolist() == [5]
    assert [bytes(r) for r in prio.RecordIOChunkReader(blob)] == [b"hello"]


def test_extract_and_find_magic():
    rec = b"ab" + MAGIC + b"cdefgh" + MAGIC
    _, blob = write_jax([rec])
    head, plen, escaped, _, _ = nb.recordio_scan(blob, 0, len(blob))
    assert escaped.tolist() == [1]        # the magic at byte 12 is aligned
    assert nb.recordio_extract(blob, int(head[0]), int(plen[0])) == rec
    words = struct.pack("<IIII", 0xCED7230A, 5, 7, 0xCED7230A)
    assert nb.find_magic_positions(words, 0xCED7230A, 10).tolist() == [0, 12]
