"""Host-compiled pipeline schedule tables (interleaved virtual stages).

The port's own copy of the dense schedules of
:mod:`tpu_dist_nn.parallel.schedule_table` (a numpy-only module): the
interleaved 1F1B training schedule and the forward-only inference
schedule, with the Megatron placement (global chunk ``c`` on stage slot
``c % S``, local chunk ``c // S``). The zero-bubble builders (split
backward, V-shape placement) belong to the LM pipeline and are not
copied.

A schedule is DATA: a greedy list-scheduler with 1F1B priority (prefer
backward once one is ready, exactly one op per slot per tick, hand-offs
modelled with one tick of transport latency) emits dense integer tables
indexed ``[slot, tick]``, and :func:`verify_tables` replays them
symbolically (every consumed value was produced, buffers never clobber
live slots, every op retired). The JAX executor plays the tables back
with receive-buffer slots; the port's executor
(:mod:`tpu_dist_nn_torch.parallel.interleaved`) reads the same tables'
op order and issues each op on its slot's CUDA stream.

Wire model: an op finishing at tick ``t`` sends its result over the
stage ring (forward: ``s -> s+1 mod S``; backward: ``s -> s-1 mod S``);
the payload is stored into a receive-buffer slot at the START of tick
``t+1`` and consumed at any tick ``>= t+1``. Chunk 0 forwards read the
input feed; chunk ``V-1`` backwards take their cotangent from the loss
tail.
"""

from __future__ import annotations

import dataclasses

import numpy as np

IDLE, FWD, BWD = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class ScheduleTables:
    """Dense ``[S, T]`` int32 tables of one schedule.

    ``op``: IDLE/FWD/BWD. ``chunk``: local chunk slot (0..v-1). ``mb``:
    microbatch id. ``stash``: input-stash slot — written by FWD, read
    and freed by BWD. ``abuf_read``: fwd input slot (-1 = the input
    feed, chunk 0). ``gbuf_read``: bwd cotangent slot (-1 = the loss
    tail, chunk V-1). ``abuf_write``/``gbuf_write``: receive-buffer slot
    into which the incoming ring payload is stored at the START of this
    tick (-1 = nothing arrives). ``is_c0``: this bwd op belongs to
    global chunk 0. ``send_rev``: 0 = the op sends on its natural ring,
    2 = on the self loopback (producer and consumer share a slot, as at
    S = 1). The ``*ch_dst`` / ``*ch_slot`` tables say, per physical
    channel (fwd ring, bwd ring, self loopback), where an arrival is
    stored (-1 = nothing, 0 = abuf, 1 = gbuf) and at which slot.
    """

    num_devices: int
    num_chunks: int
    num_microbatches: int
    ticks: int
    abuf_slots: int
    gbuf_slots: int
    stash_slots: int
    op: np.ndarray
    chunk: np.ndarray
    mb: np.ndarray
    stash: np.ndarray
    abuf_read: np.ndarray
    gbuf_read: np.ndarray
    abuf_write: np.ndarray
    gbuf_write: np.ndarray
    is_c0: np.ndarray
    send_rev: np.ndarray
    fwdch_dst: np.ndarray
    fwdch_slot: np.ndarray
    bwdch_dst: np.ndarray
    bwdch_slot: np.ndarray
    selfch_dst: np.ndarray
    selfch_slot: np.ndarray

    def channel_tables(self) -> dict:
        """The six channel-major receive tables."""
        return {name: getattr(self, name) for name in (
            "fwdch_dst", "fwdch_slot", "bwdch_dst", "bwdch_slot",
            "selfch_dst", "selfch_slot")}

    def dev_of_chunk(self, c: int) -> int:
        return c % self.num_devices

    def global_chunk(self, s: int, slot: int) -> int:
        """Inverse of (dev_of_chunk, slot): the global chunk index."""
        return slot * self.num_devices + s

    @property
    def bubble_ticks(self) -> int:
        """Idle ticks beyond the per-slot work lower bound (the max
        non-idle op count over slots: 2*M*v for a training schedule)."""
        per_device_ops = int((self.op != IDLE).sum(axis=1).max())
        return self.ticks - per_device_ops

    def op_order(self):
        """``(tick, slot, op, global chunk, microbatch)`` of every
        non-idle entry, in tick order (slots ascending within a tick):
        the order an executor issues them in."""
        for t in range(self.ticks):
            for s in range(self.num_devices):
                op = int(self.op[s, t])
                if op != IDLE:
                    yield t, s, op, self.global_chunk(s, int(self.chunk[s, t])), int(self.mb[s, t])


class _SlotPool:
    """Greedy slot allocator with exact live-interval reuse."""

    def __init__(self) -> None:
        self.free: list[int] = []
        self.high = 0

    def acquire(self) -> int:
        if self.free:
            return self.free.pop()
        slot = self.high
        self.high += 1
        return slot

    def release(self, slot: int) -> None:
        self.free.append(slot)


def _route(S: int, d_from: int, d_to: int) -> int:
    """Physical channel for a one-hop send: 0 = fwd ring (s→s+1),
    1 = bwd ring (s→s-1), 2 = self loopback."""
    if d_to == d_from:
        return 2
    if d_to == (d_from + 1) % S:
        return 0
    if d_to == (d_from - 1) % S:
        return 1
    raise ValueError(
        f"placement requires a non-neighbor hop {d_from}->{d_to} (S={S})"
    )


def _emit_tables(cols: list, S: int) -> dict:
    """Convert the scheduler's per-tick op records into the ``[S, T]``
    int32 arrays. Record contract: ``op`` + (non-idle) ``c``/``f``;
    ``stash``, ``abuf_read``/``send_abuf_slot`` (FWD),
    ``gbuf_read``/``is_c0``/``send_gbuf_slot`` (BWD). Sends land in the
    receiver's tables at tick ``t+1``."""
    T = len(cols)
    tables = {
        name: np.full((S, T), fill, dtype=np.int32)
        for name, fill in [
            ("op", IDLE), ("chunk", 0), ("mb", 0), ("stash", 0),
            ("abuf_read", -1), ("gbuf_read", -1),
            ("abuf_write", -1), ("gbuf_write", -1), ("is_c0", 0),
            ("send_rev", 0),
            ("fwdch_dst", -1), ("fwdch_slot", -1),
            ("bwdch_dst", -1), ("bwdch_slot", -1),
            ("selfch_dst", -1), ("selfch_slot", -1),
        ]
    }

    def book(ch: int, sender: int, rs: int, t_recv: int, dst: int, slot: int):
        name = ("fwdch", "bwdch", "selfch")[ch]
        at = rs if ch != 2 else sender
        if tables[f"{name}_dst"][at, t_recv] != -1:
            raise ValueError(
                f"channel {name} into device {at} double-booked at tick {t_recv}"
            )
        tables[f"{name}_dst"][at, t_recv] = dst
        tables[f"{name}_slot"][at, t_recv] = slot
        if dst == 0 and ch == 0:
            tables["abuf_write"][at, t_recv] = slot
        if dst == 1 and ch == 1:
            tables["gbuf_write"][at, t_recv] = slot

    for t_i, col in enumerate(cols):
        for s in range(S):
            rec = col[s]
            op = rec["op"]
            if op == IDLE:
                continue
            c, f = rec["c"], rec["f"]
            tables["op"][s, t_i] = op
            tables["chunk"][s, t_i] = c // S
            tables["mb"][s, t_i] = f
            tables["stash"][s, t_i] = rec.get("stash", 0)
            if op == FWD:
                tables["abuf_read"][s, t_i] = rec.get("abuf_read", -1)
                if "send_abuf_slot" in rec:
                    rs = (c + 1) % S
                    ch = _route(S, s, rs)
                    tables["send_rev"][s, t_i] = 2 if ch == 2 else (1 if ch == 1 else 0)
                    book(ch, s, rs, t_i + 1, 0, rec["send_abuf_slot"])
            else:
                tables["gbuf_read"][s, t_i] = rec.get("gbuf_read", -1)
                tables["is_c0"][s, t_i] = rec.get("is_c0", 0)
                if "send_gbuf_slot" in rec:
                    rs = (c - 1) % S
                    ch = _route(S, s, rs)
                    tables["send_rev"][s, t_i] = 2 if ch == 2 else (1 if ch == 0 else 0)
                    book(ch, s, rs, t_i + 1, 1, rec["send_gbuf_slot"])
    return tables


def _megatron_orders(S: int, v: int, M: int) -> list[list[tuple[str, int, int]]]:
    """Per-slot op order of Megatron-LM's interleaved 1F1B schedule
    (requires ``M % S == 0``): warmup of ``2(S-s-1) + (v-1)S`` forwards,
    then strict fwd/bwd alternation, microbatches advancing in waves of
    S per chunk; its bubble is ``2(S-1)`` chunk-ticks."""
    orders = []
    for s in range(S):
        total = M * v

        def fwd_k(k):
            within = k % (S * v)
            chunk = within // S
            mb = (k // (S * v)) * S + within % S
            return ("F", chunk * S + s, mb)

        def bwd_k(k):
            within = k % (S * v)
            chunk = v - 1 - within // S
            mb = (k // (S * v)) * S + within % S
            return ("B", chunk * S + s, mb)

        W = min(2 * (S - s - 1) + (v - 1) * S, total)
        ops = [fwd_k(k) for k in range(W)]
        nf, nb = W, 0
        while nf < total:
            ops.append(fwd_k(nf))
            nf += 1
            ops.append(bwd_k(nb))
            nb += 1
        while nb < total:
            ops.append(bwd_k(nb))
            nb += 1
        orders.append(ops)
    return orders


def build_interleaved_1f1b(
    num_devices: int, num_virtual: int, num_microbatches: int
) -> ScheduleTables:
    """Compile the interleaved 1F1B schedule for ``S`` slots, ``v``
    chunks per slot (``V = S*v`` in all), ``M`` microbatches.

    When ``M % S == 0`` the op order is Megatron-LM's; otherwise a
    greedy backward-first list-scheduler (any shape, some extra bubble).
    Either way the result is tick-assigned, slot-allocated and verified.
    """
    S, v, M = num_devices, num_virtual, num_microbatches
    if S < 1 or v < 1 or M < 1:
        raise ValueError(f"need S,v,M >= 1, got {S},{v},{M}")
    V = S * v
    orders = _megatron_orders(S, v, M) if M % S == 0 else None
    order_ptr = [0] * S

    fwd_done = np.full((V, M), -1, dtype=np.int64)  # completion tick
    bwd_done = np.full((V, M), -1, dtype=np.int64)
    abuf_pool = [_SlotPool() for _ in range(S)]
    gbuf_pool = [_SlotPool() for _ in range(S)]
    stash_pool = [_SlotPool() for _ in range(S)]
    abuf_slot: dict[tuple[int, int], int] = {}
    gbuf_slot: dict[tuple[int, int], int] = {}
    stash_slot: dict[tuple[int, int], int] = {}

    cols: list[list[dict]] = []
    next_fwd = [0] * V
    next_bwd = [0] * V
    done_ops = 0
    t = 0
    max_ticks = 4 * (M * v + V) + 16  # fill and drain cost ~2V ticks
    while done_ops < 2 * V * M:
        if t > max_ticks:
            raise RuntimeError(f"schedule did not converge (S={S}, v={v}, M={M})")
        col = [dict(op=IDLE) for _ in range(S)]
        # Pass 1: pick this tick's op per slot from ticks < t only.
        for s in range(S):
            chosen = None
            if orders is not None:
                if order_ptr[s] < len(orders[s]):
                    kind, c, f = orders[s][order_ptr[s]]
                    if kind == "F":
                        if c == 0 or (0 <= fwd_done[c - 1, f] and fwd_done[c - 1, f] + 1 <= t):
                            chosen = dict(op=FWD, c=c, f=f)
                    elif 0 <= fwd_done[c, f] < t and (
                            c == V - 1
                            or (bwd_done[c + 1, f] >= 0 and bwd_done[c + 1, f] + 1 <= t)):
                        chosen = dict(op=BWD, c=c, f=f)
                    if chosen is not None:
                        order_ptr[s] += 1
            else:
                # Backward first, chunks in descending global order.
                for c in range(V - 1 - ((V - 1 - s) % S), -1, -S):
                    f = next_bwd[c]
                    if f >= M or f >= next_fwd[c]:
                        continue
                    if fwd_done[c, f] < 0 or fwd_done[c, f] >= t:
                        continue
                    if c < V - 1 and (bwd_done[c + 1, f] < 0 or bwd_done[c + 1, f] + 1 > t):
                        continue
                    chosen = dict(op=BWD, c=c, f=f)
                    break
                if chosen is None:
                    # Forward: earliest microbatch, deepest ready chunk.
                    best = None
                    for c in range(s, V, S):
                        f = next_fwd[c]
                        if f >= M:
                            continue
                        if c > 0 and (fwd_done[c - 1, f] < 0 or fwd_done[c - 1, f] + 1 > t):
                            continue
                        key = (f, -c)
                        if best is None or key < best[0]:
                            best = (key, c, f)
                    if best is not None:
                        chosen = dict(op=FWD, c=best[1], f=best[2])
            if chosen is not None:
                col[s] = chosen
        # Pass 2: commit effects.
        for s in range(S):
            rec = col[s]
            if rec["op"] == FWD:
                c, f = rec["c"], rec["f"]
                slot = stash_pool[s].acquire()
                stash_slot[(c, f)] = slot
                rec["stash"] = slot
                if c > 0:
                    rslot = abuf_slot.pop((c, f))
                    rec["abuf_read"] = rslot
                    abuf_pool[s].release(rslot)
                fwd_done[c, f] = t
                next_fwd[c] = f + 1
                done_ops += 1
                if c < V - 1:
                    wslot = abuf_pool[(c + 1) % S].acquire()
                    abuf_slot[(c + 1, f)] = wslot
                    rec["send_abuf_slot"] = wslot
            elif rec["op"] == BWD:
                c, f = rec["c"], rec["f"]
                slot = stash_slot.pop((c, f))
                rec["stash"] = slot
                stash_pool[s].release(slot)
                if c < V - 1:
                    rslot = gbuf_slot.pop((c + 1, f))
                    rec["gbuf_read"] = rslot
                    gbuf_pool[s].release(rslot)
                bwd_done[c, f] = t
                next_bwd[c] = f + 1
                done_ops += 1
                rec["is_c0"] = int(c == 0)
                if c > 0:
                    wslot = gbuf_pool[(c - 1) % S].acquire()
                    gbuf_slot[(c, f)] = wslot
                    rec["send_gbuf_slot"] = wslot
        cols.append(col)
        t += 1

    out = ScheduleTables(
        num_devices=S, num_chunks=V, num_microbatches=M, ticks=len(cols),
        abuf_slots=max(p.high for p in abuf_pool) or 1,
        gbuf_slots=max(p.high for p in gbuf_pool) or 1,
        stash_slots=max(p.high for p in stash_pool) or 1,
        **_emit_tables(cols, S),
    )
    verify_tables(out)
    return out


def build_interleaved_forward(
    num_devices: int, num_virtual: int, num_microbatches: int
) -> ScheduleTables:
    """Compile a FORWARD-ONLY interleaved schedule (inference): the
    placement of :func:`build_interleaved_1f1b`, FWD/IDLE ticks only,
    greedy (earliest microbatch, deepest ready chunk). The stash is
    unused: ``stash`` stays 0 with one dummy slot."""
    S, v, M = num_devices, num_virtual, num_microbatches
    if S < 1 or v < 1 or M < 1:
        raise ValueError(f"need S,v,M >= 1, got {S},{v},{M}")
    V = S * v
    fwd_done = np.full((V, M), -1, dtype=np.int64)
    abuf_pool = [_SlotPool() for _ in range(S)]
    abuf_slot: dict[tuple[int, int], int] = {}
    cols: list[list[dict]] = []
    next_fwd = [0] * V
    done_ops = 0
    t = 0
    max_ticks = 4 * (M * v + V) + 16
    while done_ops < V * M:
        if t > max_ticks:
            raise RuntimeError(f"forward schedule did not converge (S={S}, v={v}, M={M})")
        col = [dict(op=IDLE) for _ in range(S)]
        for s in range(S):
            best = None
            for c in range(s, V, S):
                f = next_fwd[c]
                if f >= M:
                    continue
                if c > 0 and (fwd_done[c - 1, f] < 0 or fwd_done[c - 1, f] + 1 > t):
                    continue
                key = (f, -c)
                if best is None or key < best[0]:
                    best = (key, c, f)
            if best is not None:
                col[s] = dict(op=FWD, c=best[1], f=best[2])
        for s in range(S):
            rec = col[s]
            if rec["op"] != FWD:
                continue
            c, f = rec["c"], rec["f"]
            if c > 0:
                rslot = abuf_slot.pop((c, f))
                rec["abuf_read"] = rslot
                abuf_pool[s].release(rslot)
            fwd_done[c, f] = t
            next_fwd[c] = f + 1
            done_ops += 1
            if c < V - 1:
                wslot = abuf_pool[(c + 1) % S].acquire()
                abuf_slot[(c + 1, f)] = wslot
                rec["send_abuf_slot"] = wslot
        cols.append(col)
        t += 1

    out = ScheduleTables(
        num_devices=S, num_chunks=V, num_microbatches=M, ticks=len(cols),
        abuf_slots=max(p.high for p in abuf_pool) or 1, gbuf_slots=1, stash_slots=1,
        **_emit_tables(cols, S),
    )
    verify_tables(out, forward_only=True)
    return out


def verify_tables(tb: ScheduleTables, forward_only: bool = False) -> None:
    """Replay the tables with symbolic values; raise AssertionError on
    any flaw: a FWD that reads anything but its upstream chunk's output
    for its microbatch, a BWD that reads the wrong cotangent or stashed
    input, a receive that clobbers a live slot, a send whose channel
    disagrees with ``send_rev``, or a (chunk, microbatch) that does not
    run forward (and, unless ``forward_only``, backward) exactly once."""
    S, V, M, T = tb.num_devices, tb.num_chunks, tb.num_microbatches, tb.ticks
    chtb = tb.channel_tables()
    abuf = [dict() for _ in range(S)]   # slot -> symbolic value
    gbuf = [dict() for _ in range(S)]
    stash = [dict() for _ in range(S)]
    sent: list[list] = [[None] * S for _ in range(3)]  # fwd ring, bwd ring, self
    fwd_count = np.zeros((V, M), dtype=int)
    bwd_count = np.zeros((V, M), dtype=int)

    for t in range(T):
        # Start of tick: receive last tick's payloads, channel-major.
        for s in range(S):
            for ch, name in enumerate(("fwdch", "bwdch", "selfch")):
                dst = int(chtb[f"{name}_dst"][s, t])
                if dst < 0:
                    continue
                slot = int(chtb[f"{name}_slot"][s, t])
                incoming = sent[ch][s]
                if incoming is None:
                    raise AssertionError(f"t={t} s={s}: {name} write with no payload")
                buf = abuf if dst == 0 else gbuf
                if slot in buf[s]:
                    raise AssertionError(f"t={t} s={s}: {name}->buf{dst} slot {slot} clobbered")
                buf[s][slot] = incoming
        new_sent: list[list] = [[None] * S for _ in range(3)]

        def place(s, c_to, payload, natural, t=t):
            rs = tb.dev_of_chunk(c_to)
            ch = _route(S, s, rs)
            expect_rev = 2 if ch == 2 else (0 if ch == natural else 1)
            if int(tb.send_rev[s, t]) != expect_rev:
                raise AssertionError(
                    f"t={t} s={s}: send_rev {int(tb.send_rev[s, t])} != "
                    f"expected {expect_rev} for hop {s}->{rs}")
            at = rs if ch != 2 else s
            if new_sent[ch][at] is not None:
                raise AssertionError(f"t={t}: channel {ch} to {rs} double-booked")
            new_sent[ch][at] = payload

        for s in range(S):
            op = tb.op[s, t]
            if op == IDLE:
                continue
            c, f = tb.global_chunk(s, int(tb.chunk[s, t])), int(tb.mb[s, t])
            if op == FWD:
                if c == 0:
                    if tb.abuf_read[s, t] != -1:
                        raise AssertionError(f"t={t}: chunk 0 fwd must read the feed")
                else:
                    x = abuf[s].pop(int(tb.abuf_read[s, t]), None)
                    if x != ("act", c - 1, f):
                        raise AssertionError(
                            f"t={t} s={s}: fwd({c},{f}) read {x}, wanted act({c - 1},{f})")
                if not forward_only:
                    stash[s][int(tb.stash[s, t])] = ("x", c, f)
                if c < V - 1:
                    place(s, c + 1, ("act", c, f), natural=0)
                fwd_count[c, f] += 1
            else:
                x = stash[s].pop(int(tb.stash[s, t]), None)
                if x != ("x", c, f):
                    raise AssertionError(f"t={t} s={s}: bwd({c},{f}) stash read {x}")
                if c == V - 1:
                    if tb.gbuf_read[s, t] != -1:
                        raise AssertionError(f"t={t}: tail bwd must use the loss")
                else:
                    dy = gbuf[s].pop(int(tb.gbuf_read[s, t]), None)
                    if dy != ("grad", c + 1, f):
                        raise AssertionError(
                            f"t={t} s={s}: bwd({c},{f}) read {dy}, wanted grad({c + 1},{f})")
                if bool(tb.is_c0[s, t]) != (c == 0):
                    raise AssertionError(f"t={t} s={s}: is_c0 mismatch for c={c}")
                bwd_count[c, f] += 1
                if c > 0:
                    place(s, c - 1, ("grad", c, f), natural=1)
        sent = new_sent

    if not (fwd_count == 1).all():
        raise AssertionError("schedule did not run every (chunk, mb) FORWARD exactly once")
    if not forward_only and not (bwd_count == 1).all():
        raise AssertionError("schedule did not run every (chunk, mb) BACKWARD exactly once")
    if any(abuf[s] for s in range(S)) or any(gbuf[s] for s in range(S)):
        raise AssertionError("unconsumed receive-buffer values at end")
    if any(stash[s] for s in range(S)):
        raise AssertionError("unconsumed stash values at end")
