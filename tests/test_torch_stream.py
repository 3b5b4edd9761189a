"""The port's streaming plane against the JAX package's, on the CPU.

Mirrors ``tests/test_stream.py``: the TOKENS / END frames byte-equal to
JAX's encoders and each side decoding the other's; the ``TokenStream``
channel (sent-cursor dedupe of a replayed prefix, terminal ordering,
overflow and cancel); streamed greedy tokens equal to the unary
``Generate`` reply over loopback gRPC (eos included), with the port's
and JAX's clients; the per-request budget; a cancel storm releasing
slots and prefix references; the resume header (replayed tokens not
redelivered) and its ``OUT_OF_RANGE`` past ``STREAM_RESUME_MAX_TOKENS``;
a static endpoint answering UNIMPLEMENTED. Small config: vocab 64, d
32, 4 heads, 2 layers, ``max_seq_len`` 24, prompts of 8, 10 new tokens.
"""

import time

import grpc
import jax
import numpy as np
import pytest
import torch

from tpu_dist_nn.models import generate as jg
from tpu_dist_nn.models import transformer as jt
from tpu_dist_nn.serving import server as js
from tpu_dist_nn.serving import stream as jstream
from tpu_dist_nn.serving import wire as jw
from tpu_dist_nn_torch.models.transformer import TransformerConfig, transformer_params_from_jax
from tpu_dist_nn_torch.serving import wire as pw
from tpu_dist_nn_torch.serving.continuous import ContinuousScheduler
from tpu_dist_nn_torch.serving.server import GrpcClient, serve_lm_generate
from tpu_dist_nn_torch.serving.stream import TokenStream

torch.set_num_threads(1)
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=24)
JCFG, PCFG = jt.TransformerConfig(**CFG), TransformerConfig(**CFG)
JPARAMS = jt.init_transformer(jax.random.key(7), JCFG)
PARAMS = transformer_params_from_jax(jax.tree.map(np.asarray, JPARAMS), device="cpu")
T, N = 8, 10


def _prompt(seed=0):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (1, T))


def _serve(**kw):
    kw.setdefault("max_new_tokens", N)
    return serve_lm_generate(PARAMS, PCFG, 0, prompt_len=T, host="127.0.0.1", device="cpu",
                             **kw)


def _drain(stream, timeout=30.0):
    toks, end = [], None
    while True:
        ev = stream.next_event(timeout)
        assert ev is not None, "stream stalled"
        kind, data = ev
        if kind == "tokens":
            toks.extend(data)
        else:
            return toks, data


# ------------------------------------------------------------- codec


@pytest.mark.parametrize("tokens", [[0], [0, 5, 63, 1 << 20], list(range(300))])
def test_token_frames_byte_equal_to_jax_and_cross_decode(tokens):
    assert pw.encode_token_frame(tokens) == jw.encode_token_frame(tokens)
    assert pw.decode_frame(jw.encode_token_frame(tokens)) == ("tokens", tokens)
    assert jw.decode_frame(pw.encode_token_frame(tokens)) == ("tokens", tokens)


@pytest.mark.parametrize("args", [("eos",), ("max_tokens",), ("error", "DATA_LOSS", "guard"),
                                  ("error", "CANCELLED", "stream cancelled ü")])
def test_end_frames_byte_equal_to_jax_and_cross_decode(args):
    frame = pw.encode_end_frame(*args)
    assert frame == jw.encode_end_frame(*args)
    assert pw.decode_frame(frame) == jw.decode_frame(frame)
    assert pw.decode_frame(frame)[1]["reason"] == args[0]


def test_frame_decoder_rejects_garbage_like_jax():
    for bad in (b"", bytes((9, 1, 2)), pw.encode_token_frame([1, 2, 300])[:-1],
                pw.encode_token_frame([1]) + b"\x00", pw.encode_end_frame("eos")[:-1] + b"\x05"):
        for decode in (pw.decode_frame, jw.decode_frame):
            with pytest.raises(ValueError):
                decode(bad)
    assert pw.STREAM_RESUME_HEADER == jw.STREAM_RESUME_HEADER
    assert pw.STREAM_RESUME_MAX_TOKENS == jw.STREAM_RESUME_MAX_TOKENS
    assert pw.GENERATE_METHOD == jw.GENERATE_METHOD
    assert pw.GENERATE_STREAM_METHOD == jw.GENERATE_STREAM_METHOD


# ------------------------------------------------- TokenStream channel


@pytest.mark.parametrize("cls", [TokenStream, jstream.TokenStream], ids=["port", "jax"])
def test_token_stream_cursor_dedupes_replayed_prefix(cls):
    s = cls()
    assert s.publish([1, 2, 3])
    assert s.publish([1, 2, 3, 4])
    assert s.next_event(1.0) == ("tokens", [1, 2, 3, 4])
    assert s.delivered == 4
    assert s.publish([1, 2, 3, 4]) and s.next_event(0.02) is None
    s2 = cls()
    s2.seed(2)
    assert s2.publish([7, 8, 9])
    assert s2.next_event(1.0) == ("tokens", [9])


def test_token_stream_terminal_after_pending_and_first_finish_wins():
    s = TokenStream()
    s.publish([1, 2])
    s.finish("eos")
    s.finish("max_tokens", message="late loser")
    assert s.next_event(1.0) == ("tokens", [1, 2])
    assert s.next_event(1.0) == ("end", {"reason": "eos", "code": "", "message": ""})


def test_token_stream_overflow_and_cancel_flip_the_channel():
    s = TokenStream(max_buffer=2)
    assert s.publish([1, 2]) is True
    assert s.publish([1, 2, 3, 4, 5]) is False
    assert s.cancelled
    s2 = TokenStream()
    s2.cancel()
    assert s2.publish([1]) is False
    kind, data = s2.next_event(1.0)
    assert kind == "end" and data["code"] == "CANCELLED"


# ------------------------------------------------------ wire parity


def test_streamed_greedy_equal_to_unary_over_loopback_eos_included():
    prompt = _prompt(1)
    want_jax = np.asarray(jg.generate(JPARAMS, JCFG, prompt, N))[0]
    srv, port = _serve()
    try:
        for client in (GrpcClient(f"127.0.0.1:{port}"), js.GrpcClient(f"127.0.0.1:{port}")):
            want = client.generate(prompt)[0, T:]
            np.testing.assert_array_equal(want, want_jax)
            reply = client.generate_stream(prompt)
            assert list(reply) == want.tolist()
            assert reply.finish["reason"] == "max_tokens" and reply.trace_id
            client.close()
    finally:
        srv.stop(0)
    eos = int(want_jax[N // 2])
    srv, port = _serve(eos_id=eos)
    try:
        c = GrpcClient(f"127.0.0.1:{port}")
        tail = c.generate(prompt)[0, T:]
        stop = int(np.argmax(tail == eos))
        reply = c.generate_stream(prompt)
        assert list(reply) == tail[:stop + 1].tolist()
        assert reply.finish["reason"] == "eos"
        c.close()
    finally:
        srv.stop(0)


def test_stream_per_request_budget_matches_unary():
    sched = ContinuousScheduler(PARAMS, PCFG, slots=2, prompt_len=T, max_new_tokens=N,
                                device="cpu")
    try:
        prompt = _prompt(2)
        want = sched.submit(prompt, max_new_tokens=4)[0, T:T + 4]
        toks, end = _drain(sched.submit_stream(prompt, max_new_tokens=4))
        assert toks == want.tolist()
        assert end["reason"] == "max_tokens" and len(toks) == 4
        with pytest.raises(ValueError, match="ONE prompt"):
            sched.submit_stream(np.zeros((2, T), np.int32))
    finally:
        sched.close()


def test_cancel_storm_releases_slots_and_prefix_refs():
    srv, port = _serve(max_new_tokens=16, gen_slots=2, prefix_cache_blocks=4)
    sched = srv.scheduler
    try:
        c = GrpcClient(f"127.0.0.1:{port}")
        for i in range(4):
            reply = c.generate_stream(_prompt(10 + i))
            next(iter(reply))  # first token: the row is live in a slot
            reply.cancel()
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if sched.slots_active == 0 and not any(sched._pool._refs):
                break
            time.sleep(0.05)
        assert sched.slots_active == 0
        assert not any(sched._pool._refs), "leaked prefix-cache refs"
        c.close()
    finally:
        srv.stop(0)


def test_resume_header_replays_without_redelivery():
    prompt = _prompt(4)
    srv, port = _serve()
    try:
        c = GrpcClient(f"127.0.0.1:{port}")
        full = c.generate(prompt)[0, T:].tolist()
        reply = c.generate_stream(prompt, resume_tokens=full[:4])
        assert list(reply) == full[4:]
        assert reply.finish["reason"] == "max_tokens"
        # A resume already holding the whole budget answers the terminal.
        reply = c.generate_stream(prompt, resume_tokens=full)
        assert list(reply) == [] and reply.finish["reason"] == "max_tokens"
        c.close()
        # JAX's client speaks the same header by hand.
        jcli = js.GrpcClient(f"127.0.0.1:{port}")
        call = jcli._call_generate_stream(
            pw.encode_matrix(prompt),
            metadata=((pw.STREAM_RESUME_HEADER, ",".join(map(str, full[:7]))),))
        frames = [jw.decode_frame(f) for f in call]
        assert [t for k, d in frames if k == "tokens" for t in d] == full[7:]
        jcli.close()
    finally:
        srv.stop(0)


def test_resume_past_the_cap_is_out_of_range_and_garbage_invalid():
    srv, port = _serve()
    try:
        c = GrpcClient(f"127.0.0.1:{port}")
        with pytest.raises(grpc.RpcError) as ei:
            list(c.generate_stream(_prompt(5),
                                   resume_tokens=[1] * (pw.STREAM_RESUME_MAX_TOKENS + 1)))
        assert ei.value.code() == grpc.StatusCode.OUT_OF_RANGE
        assert str(pw.STREAM_RESUME_MAX_TOKENS) in ei.value.details()
        call = c._call_generate_stream(pw.encode_matrix(_prompt(5)),
                                       metadata=((pw.STREAM_RESUME_HEADER, "1,x"),))
        with pytest.raises(grpc.RpcError) as ei:
            list(call)
        assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        with pytest.raises(grpc.RpcError) as ei:
            list(c.generate_stream(np.zeros((2, T))))
        assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        c.close()
    finally:
        srv.stop(0)


def test_static_endpoint_leaves_stream_unimplemented():
    srv, port = _serve(scheduler="static")
    try:
        c = GrpcClient(f"127.0.0.1:{port}")
        with pytest.raises(grpc.RpcError) as ei:
            list(c.generate_stream(_prompt(5)))
        assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED
        jcli = js.GrpcClient(f"127.0.0.1:{port}")
        with pytest.raises(grpc.RpcError) as ei:
            list(jcli.generate_stream(_prompt(5)))
        assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED
        c.close()
        jcli.close()
    finally:
        srv.stop(0)
