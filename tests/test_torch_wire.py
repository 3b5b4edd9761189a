"""The port's wire codec and observability copies against the JAX package's.

Both packages run in this process on the same numpy-seeded inputs: the
float64 ``Row``/``Matrix`` codec (byte-identical encoding, the same
decode and the same fast-or-fallback choice, the same errors, and
agreement with protoc-generated stubs), the metric registry's text
rendering, and the trace header format.
"""

import shutil
import subprocess
import sys

import numpy as np
import pytest

from tpu_dist_nn.obs import exposition as jax_exposition
from tpu_dist_nn.obs import registry as jax_registry
from tpu_dist_nn.obs import trace as jax_trace
from tpu_dist_nn.serving import wire as jax_wire
from tpu_dist_nn_torch.obs import registry, trace
from tpu_dist_nn_torch.serving import wire

SHAPES = [(1, 1), (5, 3), (64, 784), (3, 3072)]
DTYPES = [np.float64, np.float32, np.uint8]


def _rows(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.normal(size=shape).astype(dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_encode_matrix_is_byte_identical_to_jax(shape, dtype):
    x = _rows(shape, dtype)
    got = wire.encode_matrix(x)
    assert got == jax_wire.encode_matrix(x)
    # Non-contiguous views encode the same bytes too.
    assert wire.encode_matrix(x[:, ::-1]) == jax_wire.encode_matrix(x[:, ::-1])
    np.testing.assert_array_equal(wire.decode_matrix(got), x.astype(np.float64))


def _varint(n):
    return jax_wire._varint(n)


def _unpacked(x):
    """One fixed64 field per value (a proto2-style writer)."""
    out = b""
    for row in x:
        body = b"".join(b"\x09" + np.float64(v).tobytes() for v in row)
        out += b"\x0a" + _varint(len(body)) + body
    return out


def _unknown_field(x):
    """Each row carries an extra varint field 2 before its values."""
    out = b""
    for row in x:
        payload = np.ascontiguousarray(row, "<f8").tobytes()
        body = b"\x10\x07" + b"\x0a" + _varint(len(payload)) + payload
        out += b"\x0a" + _varint(len(body)) + body
    return out


def _non_uniform_varint(x):
    """The first row's length written as a non-minimal two-byte varint."""
    packed = wire.encode_matrix(x)
    _, h, stride = jax_wire._headers(x.shape[1])
    row_len = stride - 2
    assert row_len < 128
    first = b"\x0a" + bytes([0x80 | row_len, 0x00]) + packed[2:stride]
    return first + packed[stride:]


INPUTS = {
    "packed": wire.encode_matrix,
    "unpacked": _unpacked,
    "unknown-field": _unknown_field,
    "non-uniform-varint": _non_uniform_varint,
}


@pytest.mark.parametrize("kind", list(INPUTS))
def test_decode_matches_jax_and_takes_the_same_lane(kind):
    x = np.random.default_rng(1).normal(size=(6, 5))
    data = INPUTS[kind](x)
    mine, theirs = wire._probe_fast(data), jax_wire._probe_fast(data)
    if isinstance(theirs, str):
        assert mine == theirs  # the same fallback reason
    else:
        assert (mine.n, mine.d, mine.h, mine.stride) == (
            theirs.n, theirs.d, theirs.h, theirs.stride)
    assert (kind == "packed") == (not isinstance(mine, str))
    for dtype in (np.float64, np.float32):
        got = wire.decode_matrix(data, dtype=dtype)
        np.testing.assert_array_equal(got, jax_wire.decode_matrix(data, dtype=dtype))
        np.testing.assert_array_equal(got, x.astype(dtype))
        lazy = wire.decode_matrix_lazy(data, dtype=dtype)
        assert isinstance(lazy, wire.WireMatrix) == (kind == "packed")
        np.testing.assert_array_equal(np.asarray(lazy), x.astype(dtype))
    staged = np.full((9, 5), 7.0, np.float32)
    assert wire.decode_matrix_into(data, staged, row_offset=2) == 6
    np.testing.assert_array_equal(staged[2:8], x.astype(np.float32))
    assert (staged[:2] == 7).all() and (staged[8:] == 7).all()


def _ragged():
    r2 = b"\x0a\x10" + np.zeros(2).tobytes()
    r1 = b"\x0a\x08" + np.zeros(1).tobytes()
    return b"\x0a" + bytes([len(r2)]) + r2 + b"\x0a" + bytes([len(r1)]) + r1


BAD = {
    "ragged": _ragged(),
    "truncated-row": wire.encode_matrix(np.ones((3, 4)))[:-5],
    "truncated-varint": b"\x0a\xff",
    "varint-too-long": b"\x0a" + b"\xff" * 10 + b"\x01",
    "payload-not-8": b"\x0a\x05\x0a\x03abc",
    "bad-wire-type": b"\x0b\x00",
}


@pytest.mark.parametrize("kind", list(BAD))
def test_malformed_input_raises_the_jax_message(kind):
    data = BAD[kind]
    with pytest.raises(ValueError) as want:
        jax_wire.decode_matrix(data)
    for decode in (wire.decode_matrix, wire.decode_matrix_lazy):
        with pytest.raises(ValueError) as got:
            decode(data)
        assert str(got.value) == str(want.value)


def test_encode_refuses_what_jax_refuses_and_empty_round_trips():
    with pytest.raises(ValueError, match="2-D"):
        wire.encode_matrix(np.zeros(3))
    assert wire.encode_matrix(np.zeros((0, 4))) == b""
    assert wire.decode_matrix(b"").shape == (0, 0)
    staged = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="does not match staging width"):
        wire.decode_matrix_into(wire.encode_matrix(np.ones((1, 4))), staged)
    with pytest.raises(ValueError, match="overflow staging"):
        wire.decode_matrix_into(wire.encode_matrix(np.ones((3, 3))), staged)


def test_constants_match_the_jax_wire_and_trace_names():
    for name in ("PROCESS_METHOD", "SERVICE_NAME", "SESSION_HEADER", "CLASS_HEADER",
                 "RETRY_AFTER_HEADER"):
        assert getattr(wire, name) == getattr(jax_wire, name)
    for name in ("TRACE_HEADER", "TRACE_ID_HEADER", "TIMEOUT_HEADER"):
        assert getattr(trace, name) == getattr(jax_trace, name)


@pytest.mark.skipif(shutil.which("protoc") is None, reason="protoc is not installed")
def test_both_parsers_agree_with_protoc_stubs(tmp_path):
    # A file and package of its own, so the stubs cannot collide in
    # protobuf's descriptor pool with other generated modules.
    proto = tmp_path / "torch_dist_nn.proto"
    proto.write_text('syntax = "proto3";\npackage grpc_dist_nn;\n'
                     "message Row { repeated double values = 1; }\n"
                     "message Matrix { repeated Row rows = 1; }\n")
    subprocess.run(["protoc", f"-I{tmp_path}", f"--python_out={tmp_path}", str(proto)],
                   check=True)
    sys.path.insert(0, str(tmp_path))
    try:
        import torch_dist_nn_pb2 as pb
    finally:
        sys.path.remove(str(tmp_path))
    x = np.random.default_rng(2).normal(size=(7, 13))
    m = pb.Matrix()
    m.ParseFromString(wire.encode_matrix(x))
    np.testing.assert_array_equal(np.array([list(r.values) for r in m.rows]), x)
    theirs = pb.Matrix()
    for row in x:
        theirs.rows.add().values.extend(row.tolist())
    data = theirs.SerializeToString()
    assert data == wire.encode_matrix(x)  # protoc's bytes ARE the fast lane
    for decode in (wire.decode_matrix, jax_wire.decode_matrix,
                   wire.decode_matrix_scalar, jax_wire.decode_matrix_scalar):
        np.testing.assert_array_equal(decode(data), x)


def _fill(reg, family):
    c = reg.counter("tdn_rpc_requests_total", "RPCs received, per method", labels=("method",))
    c.labels(method="Process").inc(3)
    c.labels(method='we"ird\nname').inc()
    g = reg.gauge("tdn_server_draining", "1 while draining")
    g.set(1.0)
    h = reg.histogram("tdn_batch_rows", "rows", labels=("method",),
                      buckets=family.POW2_BUCKETS)
    for v in (1, 3, 4096, 70000):
        h.labels(method="Process").observe(v)
    w = reg.histogram("tdn_batch_wait_seconds", "wait")
    w.observe(0.002)
    w.observe(float("inf"))
    return h


def test_registry_renders_what_the_jax_exposition_renders():
    mine, theirs = registry.Registry(), jax_registry.Registry()
    h_mine, h_theirs = _fill(mine, registry), _fill(theirs, jax_registry)
    assert registry.render(mine) == jax_exposition.render(theirs)
    assert registry.POW2_BUCKETS == jax_registry.POW2_BUCKETS
    assert h_mine.quantile(0.5, method="Process") == h_theirs.quantile(0.5, method="Process")
    with pytest.raises(ValueError, match="already registered"):
        mine.gauge("tdn_rpc_requests_total")


@pytest.mark.parametrize("header", [
    "0123456789abcdef0123456789abcdef-0123456789abcdef-01",
    "0123456789abcdef0123456789abcdef-0123456789abcdef-00",
    "0x23456789abcdef0123456789abcdef-0123456789abcdef-01",
    "short-0123456789abcdef-01", "", None, "a-b"])
def test_trace_header_parses_as_jax_parses_it(header):
    mine, theirs = trace.SpanContext.from_header(header), jax_trace.SpanContext.from_header(header)
    assert (mine is None) == (theirs is None)
    if mine is not None:
        assert (mine.trace_id, mine.span_id, mine.sampled) == (
            theirs.trace_id, theirs.span_id, theirs.sampled)
        assert mine.header() == theirs.header() == header


def test_tracer_records_cross_thread_spans_and_rate_zero_records_nothing():
    t = trace.Tracer(capacity=3)
    root = t.start("rpc.Process")
    t.record_span("queue_wait", root.ctx, root.t0, 0.5)
    with t.span("decode", root.ctx):
        pass
    root.end()
    names = [s.name for s in t.snapshot(trace_id=root.trace_id)]
    assert names == ["queue_wait", "decode", "rpc.Process"]
    t.record_span("fetch", root.ctx, root.t0, 0.1)
    # The ring keeps 3 spans; the evicted queue_wait still comes back
    # through the slowest-trace exemplar that the root's end kept whole.
    assert t.dropped_total == 1 and t.buffer_len() == 3
    assert [s.name for s in t.snapshot()] == ["queue_wait", "decode", "rpc.Process", "fetch"]
    t.configure(0.0)
    child = t.start("x", parent=trace.SpanContext.from_header(root.ctx.header()))
    assert not child.sampled and child.ctx.trace_id == root.trace_id
    with pytest.raises(ValueError):
        t.configure(1.5)
