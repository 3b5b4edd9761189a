"""The flash backward kernels' ordered dq sum, emulated on the CPU.

``tdn_flash_bwd_sm90`` and ``tdn_flash_bwd_f32`` add each key block's dq
partial of a query tile into one float32 workspace. They order those
adds (``csrc/common.cuh``: ``take_ticket``, ``wait_turn``): a CTA takes
its (key block, batch x head) from a ticket counter at its start, and a
turn counter per (batch x head, query tile) lets key block j add only
after block j - 1. Here CTAs are coroutines run by a scheduler that
dispatches the grid in a random order and keeps at most ``resident`` of
them on the "card" at once, as the hardware may. The sum must come out
the same bits under every dispatch order, and no schedule may deadlock;
without the tickets (work taken from the block index) a dispatch order
exists that deadlocks.
"""

from __future__ import annotations

import numpy as np
import pytest

from tpu_dist_nn_torch.kernels.flash_attention import SM90_TILES, f32_tiles


def _loops(T: int, block: int, rows: int, causal: bool):
    """For each key block: the query tiles the kernel loops over (from
    the causal start; ``block`` keys a CTA, ``rows`` queries a tile)."""
    n_kb, n_qt = -(-T // block), -(-T // rows)
    return [list(range(kb * block // rows if causal else 0, n_qt)) for kb in range(n_kb)]


def _run(T, block, rows, causal, BH, resident, dispatch, tickets, partials):
    """Run the grid; returns the summed dq tiles, or None on a deadlock."""
    loops = _loops(T, block, rows, causal)
    n_kb = len(loops)
    n_qt = -(-T // rows)
    turns = np.zeros((BH, n_qt), np.int64)
    acc = np.zeros((BH, n_qt, 4), np.float32)
    counter = [0]

    def cta(block_idx):
        ticket = counter[0] if tickets else block_idx
        counter[0] += 1
        bh, kb = ticket % BH, ticket // BH
        for i in loops[kb]:
            while turns[bh, i] != kb:
                yield False  # spinning
            acc[bh, i] += partials[bh, kb, i]
            turns[bh, i] = kb + 1
            yield True

    waiting = list(dispatch)
    running = []
    rng = np.random.default_rng(len(waiting))
    idle = 0
    while waiting or running:
        while waiting and len(running) < resident:
            running.append(cta(waiting.pop(0)))
        progressed = False
        for j in rng.permutation(len(running)):
            gen = running[j]
            try:
                progressed |= next(gen)
            except StopIteration:
                running[j] = None
                progressed = True
        running = [g for g in running if g is not None]
        idle = 0 if progressed else idle + 1
        if idle > 3:  # every resident CTA spins on a turn that cannot come
            return None
    assert n_kb * BH == counter[0]
    return acc


def _partials(BH, n_kb, n_qt, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, n_kb, n_qt, 4)) * 10.0 ** rng.integers(-3, 4, (BH, n_kb, n_qt, 1))
            ).astype(np.float32)


def _in_order(T, block, rows, causal, BH, partials):
    loops = _loops(T, block, rows, causal)
    acc = np.zeros((BH, -(-T // rows), 4), np.float32)
    for kb, tiles in enumerate(loops):
        for i in tiles:
            acc[:, i] += partials[:, kb, i]
    return acc


KERNELS = {"sm90": (SM90_TILES.block, SM90_TILES.wg_rows),
           "f32 Dh 64": (f32_tiles(64).bwd_keys, f32_tiles(64).bwd_rows)}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_ordered_sum_is_the_same_bits_under_any_dispatch_order(kernel, causal):
    block, rows = KERNELS[kernel]
    T, BH = 1024, 3
    n_kb, n_qt = -(-T // block), -(-T // rows)
    partials = _partials(BH, n_kb, n_qt, seed=1)
    want = _in_order(T, block, rows, causal, BH, partials)
    rng = np.random.default_rng(2)
    for resident in (1, 2, 5, n_kb * BH):
        for _ in range(4):
            got = _run(T, block, rows, causal, BH, resident, rng.permutation(n_kb * BH),
                       tickets=True, partials=partials)
            assert got is not None, "the ticketed grid deadlocked"
            assert np.array_equal(got, want)
    # An unordered sum (adds in arrival order) is not these bits: the
    # order is what the counters buy.
    shuffled = np.zeros_like(want)
    loops = _loops(T, block, rows, causal)
    adds = [(kb, i) for kb, tiles in enumerate(loops) for i in tiles]
    for j in rng.permutation(len(adds)):
        kb, i = adds[j]
        shuffled[:, i] += partials[:, kb, i]
    assert not np.array_equal(shuffled, want)


def test_block_index_without_tickets_can_deadlock():
    # One resident CTA that is key block 1 of a tile spins forever when
    # the hardware dispatched it before key block 0: taking work from
    # blockIdx relies on a dispatch order CUDA does not promise.
    block, rows = KERNELS["sm90"]
    T, BH = 512, 1
    n_kb, n_qt = -(-T // block), -(-T // rows)
    partials = _partials(BH, n_kb, n_qt, seed=3)
    backwards = list(reversed(range(n_kb * BH)))
    assert _run(T, block, rows, True, BH, 1, backwards, tickets=False,
                partials=partials) is None
    got = _run(T, block, rows, True, BH, 1, backwards, tickets=True, partials=partials)
    assert np.array_equal(got, _in_order(T, block, rows, True, BH, partials))
