"""Wire codec for the reference's gRPC protocol, vectorized with numpy.

Port of the ``Process`` half of :mod:`tpu_dist_nn.serving.wire`. The
reference's only message types are ``Row { repeated double values }``
and ``Matrix { repeated Row rows }`` (``src/proto/dist_nn.proto:5-11``),
proto3. This module speaks that exact wire format without protobuf
codegen: a Matrix is a sequence of field-1 length-delimited Row
messages, and a Row's values are field-1 packed little-endian doubles
(proto3 packs repeated scalars by default, and the reference's
generated stubs produce exactly this). The decoder also accepts the
unpacked encoding (one fixed64 per value) that proto2-style writers
emit, so any conforming client interoperates.

Fast lane: every row of an ``(N, D)`` matrix that this encoder (or any
packed-proto3 writer with a deterministic varint encoder, protoc
included) emits has byte-identical headers at a fixed stride, so the
whole message is one periodic byte pattern:

    [0x0A varint(row_msg_len) 0x0A varint(8*D) <8*D payload bytes>] * N

* :func:`encode_matrix` writes the message as ONE preallocated uint8
  buffer: a broadcast header write plus a single strided cast-copy of
  the payload, from any input dtype.
* :func:`decode_matrix` probes the FIRST row's structure, verifies the
  remaining headers match at stride with one vectorized compare, then
  decodes all payload doubles through one strided view; on ANY
  mismatch (unpacked encoding, unknown fields, non-uniform varints,
  ragged rows, truncation) it falls back to the general per-row parser,
  so conformance is exactly the general parser's.
* :class:`WireMatrix` / :func:`decode_matrix_lazy` defer even that one
  payload copy: the serving batcher lands wire rows DIRECTLY in its
  per-bucket staging buffer, in the engine's dtype (float32), so a
  coalesced batch is assembled from each member's raw bytes with
  exactly one cast-copy.

Fast-vs-fallback traffic is counted (``tdn_wire_decode_fast_total`` /
``tdn_wire_decode_fallback_total``) and the rate-limited
``wire.fallback`` event names why a request fell back.
"""

from __future__ import annotations

import threading

import numpy as np

from tpu_dist_nn_torch.obs.log import get_logger
from tpu_dist_nn_torch.obs.registry import REGISTRY

_TAG_ROW = 0x0A          # field 1, wire type 2 (LEN): Matrix.rows / Row.values
_WT_LEN = 2
_WT_FIXED64 = 1
_WT_VARINT = 0
_WT_FIXED32 = 5

slog = get_logger(__name__)

# Fast-path vs fallback decode traffic. The fallback counter ticking on a production server means some client's
# encoder is NOT the packed uniform layout — the decode stage silently
# runs ~10-100x slower for those requests; the wire.fallback event
# (rate-limited) names why.
_DECODE_FAST = REGISTRY.counter(
    "tdn_wire_decode_fast_total",
    "Matrix decodes served by the vectorized zero-copy fast path",
)
_DECODE_FALLBACK = REGISTRY.counter(
    "tdn_wire_decode_fallback_total",
    "Matrix decodes that fell back to the general per-row parser "
    "(unpacked rows, unknown fields, ragged widths, malformed bytes)",
)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


# Per-thread reusable encode buffer. A fresh np.empty per encode sits
# above glibc's mmap threshold for any real batch, so every call paid
# map + page-fault-on-write + unmap for the whole message (~2 ms/MB
# measured — 30x the actual byte work). One warm scratch per thread
# amortizes that to zero; the returned bytes object is the single copy
# out. Capped so a one-off huge reply can't pin 8 MB per worker thread
# forever (above the cap: fresh alloc, still one strided cast-copy).
_SCRATCH_MAX = 1 << 23
_scratch_tls = threading.local()


def _encode_scratch(nbytes: int) -> np.ndarray:
    if nbytes > _SCRATCH_MAX:
        return np.empty(nbytes, dtype=np.uint8)
    buf = getattr(_scratch_tls, "buf", None)
    if buf is None or buf.size < nbytes:
        buf = np.empty(1 << max(16, (nbytes - 1).bit_length()),
                       dtype=np.uint8)
        _scratch_tls.buf = buf
    return buf[:nbytes]


def _headers(d: int) -> tuple[bytes, int, int]:
    """(matrix_header + row_header, header_len, stride) for width ``d``
    — the per-row byte prefix every row of a packed (N, d) matrix
    shares, and the full per-row period."""
    payload_len = 8 * d
    row_header = b"\x0a" + _varint(payload_len)
    matrix_header = b"\x0a" + _varint(len(row_header) + payload_len)
    header = matrix_header + row_header
    return header, len(header), len(header) + payload_len


def encode_matrix(x) -> bytes:
    """``(N, D) array -> Matrix`` bytes (rows of packed doubles).

    Accepts ANY real dtype: the cast to the wire's little-endian
    float64 happens per-stripe into the preallocated output buffer (one
    strided cast-copy), so callers hand over their engine-dtype arrays
    directly instead of materializing an (N, D) float64 copy first.
    Byte-for-byte identical to the JAX package's encoder.
    """
    x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"matrix must be 2-D, got shape {x.shape}")
    n, d = x.shape
    if n == 0:
        return b""
    header, h, stride = _headers(d)
    if n == 1:
        # One row has nothing to broadcast: the message is the shared
        # header plus one payload cast-copy.
        return header + np.ascontiguousarray(x[0], "<f8").tobytes()
    out = _encode_scratch(n * stride)
    mat = out.reshape(n, stride)
    # Broadcast header write: every row's 0x0A/len/0x0A/len prefix is
    # the same few bytes at a fixed period.
    mat[:, :h] = np.frombuffer(header, dtype=np.uint8)
    if d:
        # ONE strided cast-copy of the whole payload: the f64 view of
        # the payload stripes is written straight from x (numpy casts
        # per-stripe; x is never materialized as float64).
        mat[:, h:].view("<f8")[...] = x
    return out.tobytes()


def _bounded(buf, pos: int, need: int) -> int:
    """Advance past ``need`` bytes, rejecting overruns — a truncated
    length-delimited field must raise like real protobuf parsers do,
    not silently decode a short slice."""
    end = pos + need
    if end > len(buf):
        raise ValueError("truncated message")
    return end


def _skip_field(buf, pos: int, wire_type: int) -> int:
    if wire_type == _WT_VARINT:
        _, pos = _read_varint(buf, pos)
        return pos
    if wire_type == _WT_FIXED64:
        return _bounded(buf, pos, 8)
    if wire_type == _WT_LEN:
        ln, pos = _read_varint(buf, pos)
        return _bounded(buf, pos, ln)
    if wire_type == _WT_FIXED32:
        return _bounded(buf, pos, 4)
    raise ValueError(f"unsupported wire type {wire_type}")


def _decode_row(buf: memoryview) -> np.ndarray:
    values: list[np.ndarray] = []
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if field == 1 and wt == _WT_LEN:        # packed doubles
            ln, pos = _read_varint(buf, pos)
            end = _bounded(buf, pos, ln)
            if ln % 8:
                raise ValueError("packed double payload not a multiple of 8")
            values.append(np.frombuffer(buf[pos:end], dtype="<f8"))
            pos = end
        elif field == 1 and wt == _WT_FIXED64:  # unpacked double
            end = _bounded(buf, pos, 8)
            values.append(np.frombuffer(buf[pos:end], dtype="<f8"))
            pos = end
        else:
            pos = _skip_field(buf, pos, wt)
    if not values:
        return np.empty((0,), dtype=np.float64)
    return np.concatenate(values)


def decode_matrix_scalar(data: bytes, dtype=np.float64) -> np.ndarray:
    """The general per-row parser: full protobuf conformance (packed OR
    unpacked values, unknown fields skipped, ragged rows rejected — the
    reference's per-layer dim check, grpc_node.py:83-84, applies to
    whole matrices). The fast path's fallback arm AND its behavioral
    oracle: whatever bytes the fast path declines must decode (or
    raise) identically here."""
    buf = memoryview(data)
    rows: list[np.ndarray] = []
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if field == 1 and wt == _WT_LEN:
            ln, pos = _read_varint(buf, pos)
            end = _bounded(buf, pos, ln)
            rows.append(_decode_row(buf[pos:end]))
            pos = end
        else:
            pos = _skip_field(buf, pos, wt)
    if not rows:
        return np.empty((0, 0), dtype=dtype)
    width = {r.shape[0] for r in rows}
    if len(width) != 1:
        raise ValueError(f"ragged matrix rows: widths {sorted(width)}")
    out = np.empty((len(rows), width.pop()), dtype=dtype)
    for i, r in enumerate(rows):
        out[i] = r  # casts the f8 row view on assignment, no f64 matrix
    return out


class _FastLayout:
    """Probed structure of a uniform packed Matrix: ``n`` rows of width
    ``d``, payload at byte ``h`` of each ``stride``-byte period."""

    __slots__ = ("n", "d", "h", "stride")

    def __init__(self, n: int, d: int, h: int, stride: int):
        self.n, self.d, self.h, self.stride = n, d, h, stride


def _probe_fast(data) -> "_FastLayout | str":
    """Validate the first row's header and the periodic structure of
    the rest; returns a :class:`_FastLayout` on success, else a short
    reason string (the fallback observability breadcrumb). Never
    raises: anything suspicious is the general parser's job, so the
    fast path can only ever decline, not diverge."""
    buf = data if isinstance(data, (bytes, bytearray)) else bytes(data)
    total = len(buf)
    try:
        if buf[0] != _TAG_ROW:
            return "first field is not Matrix.rows"
        row_len, pos = _read_varint(buf, 1)
        row_end = pos + row_len
        if row_end > total:
            return "first row truncated"
        if row_len == 0:
            # An empty Row message decodes to width 0; the general
            # parser handles the (legal, never-emitted-by-us) shape.
            return "empty first row"
        if buf[pos] != _TAG_ROW:
            return "first row value field not packed"
        payload_len, payload_start = _read_varint(buf, pos + 1)
        if payload_len % 8:
            return "payload not a multiple of 8"
        if payload_start + payload_len != row_end:
            return "extra fields in first row"
    except ValueError as e:
        return str(e)  # general parser raises the identical error
    stride = row_end
    if total % stride:
        return "trailing bytes break the row period"
    n = total // stride
    if n > 1:
        # ONE vectorized compare: every row's header must be byte-
        # identical to the first row's (same keys, same minimal-varint
        # lengths) — the check that makes the strided payload view
        # valid by construction.
        arr = np.frombuffer(buf, dtype=np.uint8)
        mat = arr.reshape(n, stride)
        if not (mat[:, :payload_start] == mat[0, :payload_start]).all():
            return "row headers not uniform at stride"
    return _FastLayout(n, payload_len // 8, payload_start, stride)


def _fast_payload_view(data, layout: _FastLayout) -> np.ndarray:
    """The ``(n, d) <f8`` strided read-only view over the raw wire
    bytes — the zero-copy half of the fast path. Consumers copy-cast
    out of it exactly once, into their own dtype/buffer. (A single
    row's payload is contiguous, so it is one offset frombuffer; the
    (d,) view broadcasts into every (1, d) consumer slot.)"""
    raw = data if isinstance(data, (bytes, bytearray)) else bytes(data)
    if layout.n == 1:
        return np.frombuffer(raw, dtype="<f8", count=layout.d,
                             offset=layout.h)
    arr = np.frombuffer(raw, dtype=np.uint8)
    return arr.reshape(layout.n, layout.stride)[:, layout.h:].view("<f8")


def _note_fallback(reason: str, nbytes: int) -> None:
    _DECODE_FALLBACK.inc()
    # Rate-limited (obs/log.py token bucket): a chatty nonconforming
    # client logs its first occurrences then ~1/s, not one line per RPC.
    slog.warning("wire.fallback", reason=reason, bytes=nbytes,
                 hint="client encoder is off the packed uniform layout; "
                      "decode runs the slow general parser")


def decode_matrix(data: bytes, dtype=np.float64) -> np.ndarray:
    """``Matrix`` bytes -> ``(N, D) dtype`` array (ragged rows rejected
    — the reference's per-layer dim check, grpc_node.py:83-84, applies
    to whole matrices).

    ``dtype`` lands rows DIRECTLY in the consumer's dtype: the serving
    path decodes into the engine's compute dtype, so the only float64
    in the process is the zero-copy f8 view of the wire bytes — the
    (N, D) float64 staging matrix the old decode-then-cast pipeline
    materialized never exists. The wire format itself stays the
    reference's packed float64 contract.

    Fast path: one structure probe + one strided view cast-copy
    (module docstring); any non-uniform/unknown/ragged/truncated input
    falls back to :func:`decode_matrix_scalar` with identical results
    and identical errors.
    """
    if len(data) == 0:
        return np.empty((0, 0), dtype=dtype)
    layout = _probe_fast(data)
    if isinstance(layout, _FastLayout):
        _DECODE_FAST.inc()
        out = np.empty((layout.n, layout.d), dtype=dtype)
        if layout.d:
            out[...] = _fast_payload_view(data, layout)
        return out
    out = decode_matrix_scalar(data, dtype=dtype)
    # Count/log AFTER the general parse: malformed bytes raise out of
    # it (the server's INVALID_ARGUMENT funnel already counts those);
    # the fallback series means "valid message, slow layout".
    _note_fallback(layout, len(data))
    return out


def decode_matrix_into(data: bytes, out: np.ndarray,
                       row_offset: int = 0) -> int:
    """Decode ``Matrix`` bytes DIRECTLY into ``out[row_offset:]`` and
    return the number of rows landed.

    The decode-into-staging half of the one-copy pipeline: the serving
    batcher hands its per-bucket staging buffer here, so a request's
    payload goes wire bytes -> device-feed buffer in ONE cast-copy —
    no intermediate (N, D) matrix, no second copy at stage time.
    Raises ``ValueError`` on a width mismatch with ``out`` (the
    caller validated the width at decode-probe time, so this firing
    means a bug, not a client error) and on overflow past ``len(out)``.
    """
    if len(data) == 0:
        return 0
    layout = _probe_fast(data)
    if isinstance(layout, _FastLayout):
        _DECODE_FAST.inc()
        # One bounds/copy contract: WireMatrix.read_into is the same
        # code the batcher's staging stage runs.
        return WireMatrix(data, layout, out.dtype).read_into(out, row_offset)
    x = decode_matrix_scalar(data)
    _note_fallback(layout, len(data))
    n, d = x.shape
    if d != out.shape[1]:
        raise ValueError(
            f"matrix width {d} does not match staging width {out.shape[1]}"
        )
    if row_offset + n > len(out):
        raise ValueError(
            f"{n} rows at offset {row_offset} overflow staging buffer "
            f"of {len(out)} rows"
        )
    out[row_offset:row_offset + n] = x
    return n


class WireMatrix:
    """A probed-but-undecoded fast-path Matrix.

    Ducks enough of the ndarray surface for the serving batcher
    (``len``, ``shape``, ``dtype``, ``ndim``) while deferring the one
    payload cast-copy until :meth:`read_into` lands the rows in the
    batcher's staging buffer — or :meth:`__array__` materializes them
    for the non-coalescing paths (``np.asarray`` just works).
    """

    __slots__ = ("_data", "_layout", "dtype")

    def __init__(self, data: bytes, layout: _FastLayout, dtype):
        self._data = data
        self._layout = layout
        self.dtype = np.dtype(dtype)

    @property
    def shape(self) -> tuple[int, int]:
        return (self._layout.n, self._layout.d)

    @property
    def ndim(self) -> int:
        return 2

    def __len__(self) -> int:
        return self._layout.n

    def read_into(self, out: np.ndarray, row_offset: int = 0) -> int:
        """Land this matrix's rows in ``out[row_offset:]`` (one strided
        cast-copy straight off the wire bytes); returns the row
        count."""
        lo = self._layout
        if lo.d != out.shape[1]:
            raise ValueError(
                f"matrix width {lo.d} does not match staging width "
                f"{out.shape[1]}"
            )
        if row_offset + lo.n > len(out):
            raise ValueError(
                f"{lo.n} rows at offset {row_offset} overflow staging "
                f"buffer of {len(out)} rows"
            )
        if lo.d:
            out[row_offset:row_offset + lo.n] = _fast_payload_view(
                self._data, lo
            )
        return lo.n

    def __array__(self, dtype=None, copy=None):
        lo = self._layout
        out = np.empty((lo.n, lo.d), dtype=dtype or self.dtype)
        if lo.d:
            out[...] = _fast_payload_view(self._data, lo)
        return out


def decode_matrix_lazy(data: bytes, dtype=np.float64):
    """Probe ``Matrix`` bytes; return a :class:`WireMatrix` (fast
    layout — payload untouched until the consumer lands it) or a fully
    decoded ndarray (fallback/general layout). The serving handler's
    entry point: shape/width validation needs only the probe, and the
    payload's single cast-copy moves to the batcher's staging stage.
    Raises the general parser's ``ValueError`` on malformed bytes."""
    if len(data) == 0:
        return np.empty((0, 0), dtype=dtype)
    layout = _probe_fast(data)
    if isinstance(layout, _FastLayout):
        _DECODE_FAST.inc()
        return WireMatrix(data, layout, dtype)
    out = decode_matrix_scalar(data, dtype=dtype)
    _note_fallback(layout, len(data))
    return out


#: The fully-qualified method the reference's stubs call — the proto
#: package is ``grpc_dist_nn`` (``src/proto/dist_nn.proto:3``), so
#: LayerServiceStub targets exactly this path.
PROCESS_METHOD = "/grpc_dist_nn.LayerService/Process"
SERVICE_NAME = "grpc_dist_nn.LayerService"
# Client -> server session key: a multi-replica router pins a session to
# one replica by it; an engine server ignores it.
SESSION_HEADER = "x-tdn-session"
# Client -> server SLO class (serving/sched_core.py): critical /
# standard / best_effort. Queue priority + shed watermark at the
# scheduler. Missing/unknown values degrade to "standard".
CLASS_HEADER = "x-tdn-class"
# Server -> client trailing metadata on RESOURCE_EXHAUSTED sheds: the
# drain-rate-derived backoff floor in milliseconds (RetryPolicy honors
# it so a shed storm cannot re-synchronize into a hot-retry storm).
RETRY_AFTER_HEADER = "x-tdn-retry-after-ms"
