"""The port's goodput plane against the JAX package's, on the CPU.

``LMFlopModel`` is an exact integer model, so the port's is held EQUAL
to JAX's on every identity of ``tests/test_goodput.py`` and the
trackers' snapshots (useful, pad by reason, per stage and per path,
launches, prefix savings) equal to JAX's after the same ``record_*``
calls; the peak resolves from the card's table by compute dtype (the
H100 SXM's dense BF16 989 TFLOP/s and FP32 67 TFLOP/s) or from the
host's BLAS; the continuous scheduler and the static Generate endpoint
conserve to the FLOP against their own launch counters.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_dist_nn.obs import goodput as jgp
from tpu_dist_nn.obs.registry import Registry as JaxRegistry
from tpu_dist_nn_torch.obs import goodput as pgp
from tpu_dist_nn_torch.obs.goodput import GOODPUT, GoodputTracker, LMFlopModel
from tpu_dist_nn_torch.obs.registry import Registry

torch.set_num_threads(1)


def _both():
    return GoodputTracker(registry=Registry()), jgp.GoodputTracker(registry=JaxRegistry())


def _same(snap, jsnap):
    # Peaks differ by design (the card's table, not the TPU's).
    for key in ("peak_flops", "peak_source", "mfu"):
        snap.pop(key), jsnap.pop(key)
    assert snap == jsnap


def _delta(after, before, *keys):
    a, b = after, before
    for k in keys:
        a, b = a[k], (b.get(k, {}) if isinstance(b, dict) else b)
    return a - (b if isinstance(b, (int, float)) else 0)


@pytest.mark.parametrize("shape", [(3, 32, 64, 48, 19), (12, 768, 3072, 256, 383)])
def test_lm_model_identities_equal_jax(shape):
    m, jm = LMFlopModel(*shape), jgp.LMFlopModel(*shape)
    assert m.step_useful_flops(m.M - 1) == m.step_flops() == jm.step_flops()
    assert m.step_useful_flops(0) < m.step_flops()
    for p in (0, 5, m.M - 1):
        assert m.step_useful_flops(p) == jm.step_useful_flops(p)
    assert m.steps_useful_sum(7, 5) == sum(m.step_useful_flops(p) for p in range(7, 12))
    assert m.steps_useful_sum(7, 5) == jm.steps_useful_sum(7, 5)
    assert m.steps_useful_sum(7, 0) == 0
    for start, size, final in ((0, 4, True), (4, 4, False), (3, 9, True)):
        assert m.chunk_flops(size) == jm.chunk_flops(size)
        assert m.chunk_useful_flops(start, size, final) == jm.chunk_useful_flops(start, size,
                                                                                 final)
    assert m.prefill_chunks_flops(0, 10, 4) == 2 * m.chunk_flops(4) + m.chunk_flops(2)
    assert m.prefill_chunks_flops(0, 10, None) == m.chunk_flops(10)
    assert m.prefill_chunks_flops(64, 128, 64) == jm.prefill_chunks_flops(64, 128, 64)
    assert pgp.fcnn_flops_per_row([784, 128, 64, 10]) == jgp.fcnn_flops_per_row(
        [784, 128, 64, 10]) == 2 * (784 * 128 + 128 * 64 + 64 * 10)


def test_record_snapshots_equal_jax():
    m, jm = LMFlopModel(2, 32, 64, 48, 11), jgp.LMFlopModel(2, 32, 64, 48, 11)
    t, jt = _both()
    out = np.zeros((3, 12), np.int64)
    out[0, 8:] = [5, 9, 9, 9]
    out[1, 8:] = [1, 2, 3, 4]
    for tr, mm in ((t, m), (jt, jm)):
        tr.record_decode_step(mm, [3, 7], 1, 1)
        tr.record_decode_step(mm, [], 4, 0)
        tr.record_decode_step(mm, [5], 0, 3, replay_slots=2)
        tr.record_prefill_chunk(mm, 0, 4, final=False)
        tr.record_prefill_chunk(mm, 4, 4, final=True)
        tr.record_static_generate(mm, out, 2, 3, 8, 9)
        tr.record_static_generate(mm, out, 2, 3, 8, None, dead_rows=1)
        tr.record_rows(100, 4, 3, path="batcher")
        tr.record_prefix_saved(1234)
    _same(t.snapshot(), jt.snapshot())
    snap = t.snapshot()
    assert snap["flops"]["useful"] + snap["flops"]["pad"] == snap["flops"]["total"]
    assert snap["pad_reasons"]["eos_frozen"] == 2 * m.step_flops()
    assert snap["pad_reasons"]["preempt_replay"] == 2 * m.step_flops()


def test_disabled_tracker_records_nothing():
    m = LMFlopModel(1, 8, 16, 8, 4)
    t = GoodputTracker(registry=Registry())
    t.enabled = False
    t.record_rows(100, 4, 3, path="batcher")
    t.record_decode_step(m, [1], 1, 0)
    t.record_prefill_chunk(m, 0, 2, final=True)
    t.record_prefix_saved(1000)
    snap = t.snapshot()
    assert snap["flops"]["total"] == 0 and snap["launches"] == 0
    assert snap["flops"]["prefix_saved"] == 0


def test_mfu_tick_and_pad_ratio_gauges_equal_jax():
    reg, jreg = Registry(), JaxRegistry()
    t, jt = GoodputTracker(registry=reg), jgp.GoodputTracker(registry=jreg)
    for tr in (t, jt):
        tr.set_peak(1e9, "test")
        tr.tick(now=100.0)
        tr.record_rows(500_000, 4, 3, path="batcher")
        tr.tick(now=101.0)
    assert reg.get("tdn_mfu_ratio").labels().value == pytest.approx(1_500_000 / 1e9)
    assert (reg.get("tdn_mfu_ratio").labels().value
            == jreg.get("tdn_mfu_ratio").labels().value)
    assert reg.get("tdn_pad_ratio").labels(path="batcher").value == pytest.approx(0.25)
    t.tick(now=102.0)
    assert reg.get("tdn_mfu_ratio").labels().value == 0.0


def test_peak_resolves_from_the_card_table_by_dtype_else_the_host():
    name = "NVIDIA H100 80GB HBM3"
    assert pgp.device_peak_flops(name, "bfloat16") == 989e12
    assert pgp.device_peak_flops(name, "float32") == 67e12
    assert pgp.device_peak_flops("TPU v5 lite") is None
    assert pgp.resolve_peak(name, "float32") == (67e12, f"table:{name}:float32")
    peak, source = pgp.resolve_peak(None)
    assert peak > 0 and source == "measured-host-blas"
    t = GoodputTracker(registry=Registry())
    assert t.ensure_peak(device_kind=name, device_count=4) == 4 * 989e12
    assert t.snapshot()["peak_source"] == f"table:{name}:bfloat16 x4"
    assert t.ensure_peak(device_kind=name, device_count=1) == 4 * 989e12  # the max stays
    t2 = GoodputTracker(registry=Registry())
    assert t2.ensure_peak(device_kind=name, dtype="float32") == 67e12
    t3 = GoodputTracker(registry=Registry())
    assert t3.ensure_peak() == peak  # no card here: the host's BLAS


def test_continuous_scheduler_conservation_and_prefix_savings():
    from tpu_dist_nn.models import transformer as jt
    from tpu_dist_nn_torch.models.transformer import TransformerConfig, transformer_params_from_jax
    from tpu_dist_nn_torch.serving.continuous import ContinuousScheduler

    cfg = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_seq_len=16)
    jparams = jt.init_transformer(jax.random.key(0), jt.TransformerConfig(**cfg))
    params = transformer_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    g0 = GOODPUT.snapshot()
    sched = ContinuousScheduler(params, TransformerConfig(**cfg), slots=2, prompt_len=8,
                                max_new_tokens=4, prefix_cache_blocks=2, prefill_chunk=4,
                                device="cpu")
    try:
        prompt = np.zeros((1, 8), np.int32)
        sched.submit(prompt)
        sched.submit(prompt)  # the same prompt: a prefix hit on admission
    finally:
        sched.close()
    g1 = GOODPUT.snapshot()
    m = sched._gp_model
    du, dp = _delta(g1, g0, "flops", "useful"), _delta(g1, g0, "flops", "pad")
    assert du + dp == (sched.prefill_chunks_total * m.chunk_flops(4)
                       + sched.steps_total * sched.slots * m.step_flops())
    assert du > 0 and dp > 0
    assert _delta(g1, g0, "flops", "prefix_saved") == m.prefill_chunks_flops(0, 4, 4)
    assert g1["pad_reasons"].get("idle_slot", 0) > g0["pad_reasons"].get("idle_slot", 0)


def test_static_generate_loopback_records():
    from tpu_dist_nn_torch.models.transformer import TransformerConfig, init_transformer
    from tpu_dist_nn_torch.serving.server import GrpcClient, serve_lm_generate

    cfg = TransformerConfig(vocab_size=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                            max_seq_len=16)
    params = init_transformer(torch.Generator().manual_seed(0), cfg, device="cpu")
    srv, port = serve_lm_generate(params, cfg, 0, max_new_tokens=4, prompt_len=8,
                                  host="127.0.0.1", scheduler="static", device="cpu")
    client = GrpcClient(f"127.0.0.1:{port}")
    try:
        g0 = GOODPUT.snapshot()
        client.generate(np.zeros((1, 8)))
        g1 = GOODPUT.snapshot()
        m = LMFlopModel.from_config(cfg, 8 + 4 - 1)
        row_total = m.chunk_flops(8) + (4 - 1) * m.step_flops()
        assert _delta(g1, g0, "flops", "total") == row_total
        assert _delta(g1, g0, "flops", "useful") + _delta(g1, g0, "flops", "pad") == row_total
    finally:
        client.close()
        srv.stop(0)
