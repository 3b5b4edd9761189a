"""The port's zero-bubble schedule tables against the JAX package's.

``tpu_dist_nn_torch.parallel.schedule_table`` is the port's own copy of
the numpy-only JAX module; these tests hold every field of every table
equal, array for array, at ``tests/test_zero_bubble.py``'s and
``tests/test_zb_v.py``'s shapes, and repeat those files' accounting: the
bubble (zb ``S - 1`` ticks against 1F1B's and the coupled control's
``2(S - 1)``), the stash bounds, the V placement, and the symbolic
replay's refusal of a clobbered stash.
"""

import dataclasses

import numpy as np
import pytest

from tpu_dist_nn.parallel import schedule_table as jst
from tpu_dist_nn_torch.parallel import schedule_table as st
from tpu_dist_nn_torch.parallel.interleaved import table_order
from tpu_dist_nn_torch.parallel.one_f_one_b import training_order


def _assert_same(got, want):
    names = {f.name for f in dataclasses.fields(want)}
    assert names == {f.name for f in dataclasses.fields(got)}
    for name in sorted(names):
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, (name, a, b)


@pytest.mark.parametrize("S,v,M", [(2, 1, 4), (4, 1, 8), (3, 1, 5), (2, 2, 4), (1, 1, 3)])
@pytest.mark.parametrize("couple_w", [False, True], ids=["zb", "coupled"])
def test_zero_bubble_tables_equal_jax(S, v, M, couple_w):
    got = st.build_zero_bubble(S, v, M, couple_w=couple_w)
    _assert_same(got, jst.build_zero_bubble(S, v, M, couple_w=couple_w))
    assert int((got.op != st.IDLE).sum()) == 3 * S * v * M
    assert int((got.op == st.BWD_B).sum()) == int((got.op == st.BWD_W).sum()) == S * v * M


@pytest.mark.parametrize("S,M", [(2, 2), (2, 4), (4, 4), (4, 8), (3, 5), (8, 8)])
def test_zb_v_tables_equal_jax(S, M):
    got = st.build_zb_v(S, M)
    _assert_same(got, jst.build_zb_v(S, M))
    assert got.placement == "vshape" and got.num_chunks == 2 * S
    # the placement's one definition: chunk <-> (slot, local chunk)
    for c in range(2 * S):
        s = got.dev_of_chunk(c)
        assert got.global_chunk(s, c // S) == c


@pytest.mark.parametrize("S,v,M", [(2, 2, 4), (4, 1, 8), (3, 2, 6)])
def test_combined_backward_tables_still_equal_jax(S, v, M):
    _assert_same(st.build_interleaved_1f1b(S, v, M), jst.build_interleaved_1f1b(S, v, M))
    _assert_same(st.build_interleaved_forward(S, v, M), jst.build_interleaved_forward(S, v, M))


def test_zb_halves_the_1f1b_bubble():
    for S, M in [(2, 4), (4, 8), (8, 16)]:
        zb = st.build_zero_bubble(S, 1, M)
        coupled = st.build_zero_bubble(S, 1, M, couple_w=True)
        fb = st.build_interleaved_1f1b(S, 1, M)
        assert zb.bubble_ticks == S - 1, (S, M, zb.bubble_ticks)
        assert coupled.bubble_ticks == 2 * (S - 1), (S, M, coupled.bubble_ticks)
        assert fb.bubble_ticks == 2 * (S - 1), (S, M, fb.bubble_ticks)


def test_zb_v_bubble_against_the_same_granularity():
    for S, M in [(2, 4), (4, 4), (8, 8), (4, 8)]:
        vshape = st.build_zb_v(S, M)
        assert vshape.bubble_ticks == S - 1
        assert vshape.bubble_ticks <= st.build_zero_bubble(S, 2, M).bubble_ticks
        assert vshape.bubble_ticks < st.build_interleaved_1f1b(S, 2, M).bubble_ticks


def test_zb_memory_stays_o_stages():
    """``tests/test_zero_bubble.py:67``'s bounds: the input stash within
    3S slots and the cotangent stash within S + 1, whatever M."""
    for S, M in [(2, 16), (4, 32), (8, 32), (4, 64)]:
        tb = st.build_zero_bubble(S, 1, M)
        assert tb.stash_slots <= 3 * S, (S, M, tb.stash_slots)
        assert tb.dybuf_slots <= S + 1, (S, M, tb.dybuf_slots)


def test_zb_v_placement_properties():
    S, M = 4, 4
    tb = st.build_zb_v(S, M)
    assert tb.dev_of_chunk(0) == 0 and tb.dev_of_chunk(2 * S - 1) == 0
    assert tb.dev_of_chunk(S - 1) == S - 1 and tb.dev_of_chunk(S) == S - 1
    assert (tb.selfch_dst >= 0).any()  # the apex hand-off stays on its slot
    feeds = (tb.op == st.FWD) & (tb.abuf_read == -1)
    assert feeds[0].any() and not feeds[1:].any()
    tails = (tb.op == st.BWD_B) & (tb.gbuf_read == -1)
    assert tails[0].any() and not tails[1:].any()


@pytest.mark.parametrize("field", ["stash", "dy_stash"])
def test_verify_tables_refuses_a_clobbered_stash_slot(field):
    """Point a second live (chunk, microbatch) at the slot of the first:
    the symbolic replay finds the clobber (or the wrong value read)."""
    tb = st.build_zero_bubble(2, 1, 4)
    table = getattr(tb, field).copy()
    if field == "stash":
        writes = np.argwhere(tb.op == st.FWD)
    else:
        writes = np.argwhere(tb.op == st.BWD_B)
    (s0, t0), (s1, t1) = [w for w in writes if w[0] == writes[0][0]][:2]
    table[s1, t1] = table[s0, t0]
    broken = dataclasses.replace(tb, **{field: table})
    with pytest.raises(AssertionError):
        st.verify_tables(broken)
    st.verify_tables(tb)


@pytest.mark.parametrize("schedule,S,v,M", [("zb", 2, 1, 4), ("zb-stash", 4, 1, 4),
                                             ("zb-v", 3, 2, 4), ("interleaved", 2, 2, 4)])
def test_training_order_carries_every_op_of_the_tables(schedule, S, v, M):
    order = training_order(schedule, S, v, M)
    tb = (st.build_zb_v(S, M) if schedule == "zb-v" else st.build_interleaved_1f1b(S, v, M)
          if schedule == "interleaved" else st.build_zero_bubble(S, v, M))
    assert order == table_order(tb)
    assert len(order) == int((tb.op != st.IDLE).sum())
    for s, _op, c, _m in order:  # each op on the slot that holds its chunk
        assert tb.dev_of_chunk(c) == s
