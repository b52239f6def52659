"""The port's MTWAL001 wire protocol held against the JAX package's, case by case (``tests/test_serve_protocol.py``).

The socket stream IS the journal format: each package's stream decoder must
accept and reject bytes under exactly the rules of its ``IngestWAL`` reader,
over truncations at every byte, a bit flip at every byte, oversized declared
lengths and alien magic. Then the cross-package pins: a record of numpy
payloads encodes to the same bytes in both packages, and each package's
``decode_blob`` reads the other's streams (damaged or not) to the same records
and the same tear. Then the wire's refusals: a frame that pickles a tensor, any
torch global or a JAX array reads as damage in the port.
"""

from __future__ import annotations

import pickle
import struct
import zlib

import numpy as np
import pytest
import torch

from test_torch_serve_cases import same, serve_side

RECORDS = [
    ("add", 1, "s0", ("__metric__", b"\x80\x05N.")),
    ("submit", 2, "s0", ((np.arange(6, dtype=np.int32).reshape(2, 3),), {})),
    ("expire", 3, "sess with spaces é", None),
    ("hello", 0, "prod-a", {"key": "k", "producer": "prod-a", "proto": 1}),
]

SIDES = ("jax", "torch")


def _blob(name: str) -> bytes:
    sv = serve_side(name)
    return sv.WAL_MAGIC + b"".join(sv.encode_frame(*rec) for rec in RECORDS)


def _file_verdict(name: str, tmp_path, blob: bytes):
    path = tmp_path / f"pin-{name}.wal"
    path.write_bytes(blob)
    return serve_side(name).durability.IngestWAL.read_records_detailed(path)


def _pin(tmp_path, blob: bytes, reader: str = "torch", decoder: str = "torch") -> None:
    """``decoder``'s stream decode agrees with ``reader``'s file reader on records AND tear site."""
    want_records, want_torn = _file_verdict(reader, tmp_path, blob)
    got_records, got_torn = serve_side(decoder).protocol.decode_blob(blob)
    assert got_torn == want_torn, (reader, decoder, got_torn, want_torn)
    assert same(got_records, want_records)


# ------------------------------------------------------------------- writer
@pytest.mark.parametrize("name", SIDES)
def test_encode_frame_writes_exactly_what_ingest_wal_appends(tmp_path, name):
    sv = serve_side(name)
    path = tmp_path / "w.wal"
    wal = sv.durability.IngestWAL(path)
    for rec in RECORDS:
        wal.append(*rec)
    wal.close()
    assert path.read_bytes() == _blob(name)


def test_numpy_records_encode_to_the_same_bytes_in_both_packages():
    assert _blob("torch") == _blob("jax")
    rng = np.random.default_rng(5)
    extra = [
        ("submit", 7, 12, ((rng.random(5, dtype=np.float32), rng.integers(0, 2, 5)), {"w": np.float64(0.5)})),
        ("reset", 8, None, None),
        ("ack", 9, "s1", {"status": "defer", "rule": "ordering", "retry_after_s": 0.05}),
    ]
    for rec in extra:
        assert serve_side("torch").encode_frame(*rec) == serve_side("jax").encode_frame(*rec)


@pytest.mark.parametrize("name", SIDES)
def test_metric_payloads_get_the_wal_tagging(tmp_path, name):
    sv = serve_side(name)
    path = tmp_path / "m.wal"
    wal = sv.durability.IngestWAL(path)
    wal.append("add", 1, "s0", sv.s.pkg.SumMetric(**sv.s.kw))
    wal.close()
    assert path.read_bytes() == sv.WAL_MAGIC + sv.encode_frame("add", 1, "s0", sv.s.pkg.SumMetric(**sv.s.kw))


def test_port_metric_blob_holds_numpy_arrays_never_tensors():
    sv = serve_side("torch")
    m = sv.metric()
    m.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    (kind, _seq, _sid, payload), = sv.protocol.decode_blob(sv.WAL_MAGIC + sv.encode_frame("add", 1, "s0", m))[0]
    assert kind == "add" and payload[0] == "__metric__"
    # the blob itself names numpy for every state: no torch tensor rebuild inside
    assert b"_rebuild_tensor" not in payload[1]
    back = sv.durability.unpack_metric(payload[1])
    assert back.state_fingerprint() == m.state_fingerprint()


# ---------------------------------------------------------------- fuzz pins
@pytest.mark.parametrize("name", SIDES)
def test_clean_blob_decodes_identically(tmp_path, name):
    blob = _blob(name)
    _pin(tmp_path, blob, name, name)
    records, torn = serve_side(name).protocol.decode_blob(blob)
    assert torn is None
    assert [r[0] for r in records] == [r[0] for r in RECORDS]


@pytest.mark.parametrize("reader,decoder", [("torch", "torch"), ("jax", "torch"), ("torch", "jax")])
def test_truncation_at_every_byte_boundary_pins_the_file_reader(tmp_path, reader, decoder):
    """Each package's decoder against each package's file reader, over the other package's stream too."""
    blob = _blob(reader)
    for cut in range(len(blob)):
        _pin(tmp_path, blob[:cut], reader, decoder)


@pytest.mark.parametrize("reader,decoder", [("torch", "torch"), ("jax", "torch"), ("torch", "jax")])
def test_single_bit_flip_at_every_byte_pins_the_file_reader(tmp_path, reader, decoder):
    blob = _blob(reader)
    rng = np.random.default_rng(7)
    for i in range(len(blob)):
        flipped = bytearray(blob)
        flipped[i] ^= 1 << int(rng.integers(0, 8))
        _pin(tmp_path, bytes(flipped), reader, decoder)


def test_each_package_decodes_the_other_s_damaged_streams_alike():
    """The same damaged bytes give both decoders the same records and the same tear."""
    rng = np.random.default_rng(11)
    blob = _blob("torch")
    cases = [blob[:cut] for cut in range(0, len(blob), 7)]
    for i in range(0, len(blob), 5):
        flipped = bytearray(blob)
        flipped[i] ^= 1 << int(rng.integers(0, 8))
        cases.append(bytes(flipped))
    for case in cases:
        got_t = serve_side("torch").protocol.decode_blob(case)
        got_j = serve_side("jax").protocol.decode_blob(case)
        assert got_t[1] == got_j[1] and same(got_t[0], got_j[0])


@pytest.mark.parametrize("name", SIDES)
def test_alien_magic_is_torn_at_offset_zero(tmp_path, name):
    blob = b"ALIENMAG" + _blob(name)[len(serve_side(name).WAL_MAGIC):]
    _pin(tmp_path, blob, name, name)
    records, torn = serve_side(name).protocol.decode_blob(blob)
    assert records == [] and torn == {"frame_index": 0, "byte_offset": 0}


@pytest.mark.parametrize("name", SIDES)
def test_oversized_declared_length_pins_the_file_reader(tmp_path, name):
    blob = _blob(name) + struct.pack(">II", 1 << 30, 0)
    _pin(tmp_path, blob, name, name)


# ------------------------------------------------ the documented divergences
_EXECUTED = []


def _boom(arg):
    _EXECUTED.append(arg)
    return arg


class _Gadget:
    """The classic pickle RCE shape: __reduce__ names an arbitrary callable."""

    def __reduce__(self):
        return (_boom, ("pwned",))


@pytest.mark.parametrize("name", SIDES)
def test_hostile_pickle_frame_is_damage_not_code_execution(name):
    sv = serve_side(name)
    _EXECUTED.clear()
    evil = sv.encode_frame("submit", 1, "s0", _Gadget())
    dec = sv.protocol.FrameDecoder()
    with pytest.raises(sv.protocol.ProtocolError, match="disallowed global"):
        dec.feed(sv.WAL_MAGIC + evil)
    assert _EXECUTED == []
    records, torn = sv.protocol.decode_blob(sv.WAL_MAGIC + evil)
    assert records == [] and torn == {"frame_index": 0, "byte_offset": len(sv.WAL_MAGIC)}


def test_safe_globals_cover_real_producer_payloads():
    """Everything a conforming port producer pickles decodes: plain data, numpy arrays and scalars, tensors
    (which travel as numpy arrays) and the tagged metric blob."""
    sv = serve_side("torch")
    payloads = [
        {"key": "k", "proto": 1},
        ((np.arange(6, dtype=np.int32).reshape(2, 3), np.float32(0.5)), {"w": np.int64(2)}),
        ((torch.arange(4), torch.tensor([0.5, 1.5])), {"w": torch.tensor(2)}),
        ("__metric__", b"\x80\x05N."),
    ]
    blob = sv.WAL_MAGIC + b"".join(sv.encode_frame("submit", i + 1, "s0", p) for i, p in enumerate(payloads))
    records, torn = sv.protocol.decode_blob(blob)
    assert torn is None and len(records) == len(payloads)
    got = records[1][3]
    assert isinstance(got[0][0], np.ndarray) and got[0][0].dtype == np.int32
    (a, b), kw = records[2][3]
    assert isinstance(a, np.ndarray) and a.dtype == np.int64 and np.array_equal(a, np.arange(4))
    assert isinstance(b, np.ndarray) and b.dtype == np.float32 and isinstance(kw["w"], np.ndarray)
    # the tensor record carries what the same numpy record carries, byte for byte
    assert sv.encode_frame("submit", 3, "s0", payloads[2]) == sv.encode_frame(
        "submit", 3, "s0", ((np.arange(4), np.array([0.5, 1.5], dtype=np.float32)), {"w": np.array(2)}))
    assert set(sv.protocol.SAFE_PICKLE_GLOBALS) == set(serve_side("jax").protocol.SAFE_PICKLE_GLOBALS) - {
        ("jax._src.array", "_reconstruct_array")}


def _raw_frame(record) -> bytes:
    body = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
    return struct.pack(">II", len(body), zlib.crc32(body) & 0xFFFFFFFF) + body


@pytest.mark.parametrize("payload", ["tensor", "device", "dtype", "jax_array"])
def test_torch_globals_and_jax_arrays_read_as_damage_in_the_port(payload):
    """A frame pickled around the encoder (a raw tensor, a torch device or dtype, a JAX array) names a global
    outside the allowlist: the port's decoder refuses it before anything is imported."""
    sv = serve_side("torch")
    if payload == "jax_array":
        import jax.numpy as jnp

        value = jnp.arange(4)
    else:
        value = {"tensor": torch.arange(4), "device": torch.device("cpu"), "dtype": torch.float32}[payload]
    frame = _raw_frame(("submit", 1, "s0", ((value,), {})))
    with pytest.raises(sv.protocol.ProtocolError, match="disallowed global"):
        sv.protocol.FrameDecoder().feed(sv.WAL_MAGIC + frame)
    records, torn = sv.protocol.decode_blob(sv.WAL_MAGIC + frame)
    assert records == [] and torn == {"frame_index": 0, "byte_offset": len(sv.WAL_MAGIC)}


@pytest.mark.parametrize("name", SIDES)
def test_streaming_decoder_rejects_oversized_frames_before_the_body(name):
    sv = serve_side(name)
    dec = sv.protocol.FrameDecoder(max_frame_bytes=1024)
    dec.feed(sv.WAL_MAGIC)
    with pytest.raises(sv.protocol.ProtocolError, match="oversized"):
        dec.feed(struct.pack(">II", 2048, 0))
    assert sv.protocol.DEFAULT_MAX_FRAME_BYTES == 64 << 20


# ----------------------------------------------------------- damage contract
@pytest.mark.parametrize("name", SIDES)
def test_damage_carries_prior_records_and_the_byte_offset(name):
    sv = serve_side(name)
    f1 = sv.encode_frame(*RECORDS[0])
    f2 = sv.encode_frame(*RECORDS[1])
    bad = bytearray(sv.encode_frame(*RECORDS[2]))
    bad[-1] ^= 0xFF
    dec = sv.protocol.FrameDecoder()
    with pytest.raises(sv.protocol.ProtocolError, match="crc") as exc_info:
        dec.feed(sv.WAL_MAGIC + f1 + f2 + bytes(bad))
    exc = exc_info.value
    assert [r[0] for r in exc.records] == ["add", "submit"]
    assert exc.byte_offset == len(sv.WAL_MAGIC) + len(f1) + len(f2)


@pytest.mark.parametrize("name", SIDES)
def test_unpicklable_and_non_record_bodies_are_framing_damage(name):
    sv = serve_side(name)

    def _frame_of(body: bytes) -> bytes:
        return struct.pack(">II", len(body), zlib.crc32(body) & 0xFFFFFFFF) + body

    dec = sv.protocol.FrameDecoder(expect_magic=False)
    with pytest.raises(sv.protocol.ProtocolError, match="unpickle"):
        dec.feed(_frame_of(b"\x00not a pickle"))
    dec = sv.protocol.FrameDecoder(expect_magic=False)
    with pytest.raises(sv.protocol.ProtocolError, match="record"):
        dec.feed(_frame_of(pickle.dumps(("only", "three", "fields"))))


# ------------------------------------------------------------------ streaming
@pytest.mark.parametrize("name", SIDES)
def test_byte_at_a_time_streaming_equals_the_one_shot_decode(name):
    sv = serve_side(name)
    blob = _blob(name)
    dec = sv.protocol.FrameDecoder()
    records = []
    for i in range(len(blob)):
        records.extend(dec.feed(blob[i:i + 1]))
    assert same(records, sv.protocol.decode_blob(blob)[0])
    assert dec.pending_bytes() == 0
    assert dec.bytes_consumed == len(blob)
    assert dec.frames_decoded == len(RECORDS)


@pytest.mark.parametrize("name", SIDES)
def test_partial_magic_waits_and_wrong_magic_fails_fast(name):
    sv = serve_side(name)
    dec = sv.protocol.FrameDecoder()
    assert dec.feed(sv.WAL_MAGIC[:4]) == []
    assert dec.feed(sv.WAL_MAGIC[4:]) == []
    dec = sv.protocol.FrameDecoder()
    with pytest.raises(sv.protocol.ProtocolError, match="magic"):
        dec.feed(b"MTX")


def test_namespace_and_constants_equal_the_jax_package_s():
    t, j = serve_side("torch"), serve_side("jax")
    assert t.serve.__all__ == j.serve.__all__ and len(t.serve.__all__) == 19
    assert t.protocol.__all__ == j.protocol.__all__
    for name in ("PROTO_VERSION", "DEFAULT_WINDOW", "DEFAULT_MAX_FRAME_BYTES", "DATA_KINDS", "CONTROL_KINDS",
                 "WAL_MAGIC"):
        assert getattr(t.protocol, name) == getattr(j.protocol, name), name
    assert t.admission.DEFAULT_ADMISSION_TABLE == j.admission.DEFAULT_ADMISSION_TABLE
    assert t.admission.ADMISSION_VERDICTS == j.admission.ADMISSION_VERDICTS
    assert t.autonomic.AUTONOMIC_ACTIONS == j.autonomic.AUTONOMIC_ACTIONS
    assert t.autonomic.AUTONOMIC_ENGINE_ALLOWLIST == j.autonomic.AUTONOMIC_ENGINE_ALLOWLIST
