"""Host-compiled pipeline schedule tables (interleaved virtual stages, zero bubble).

The port's own copy of :mod:`tpu_dist_nn.parallel.schedule_table` (a
numpy-only module): the interleaved 1F1B training schedule, the
forward-only inference schedule, and the zero-bubble schedules of the LM
pipeline, whose backward is split into ``BWD_B`` (the input gradient,
on the critical path) and ``BWD_W`` (the weight gradient, which nothing
downstream waits for): ZB-H1 (:func:`build_zero_bubble`, on the
Megatron placement) and ZB-V (:func:`build_zb_v`, on the V-shape
placement). A table's ``placement`` says where global chunk ``c`` sits:
"megatron", stage slot ``c % S`` at local chunk ``c // S``; "vshape"
(two chunks a slot), slot ``c`` for ``c < S`` and ``2S-1-c`` after,
local chunk ``c // S``. :meth:`ScheduleTables.dev_of_chunk` and
:meth:`ScheduleTables.global_chunk` are the one definition of both.

A schedule is DATA: a greedy list-scheduler (exactly one op per slot per
tick, hand-offs modelled with one tick of transport latency) emits dense
integer tables indexed ``[slot, tick]``, and :func:`verify_tables`
replays them symbolically (every consumed value was produced, buffers
never clobber live slots, every op retired). The JAX executor plays the
tables back with receive-buffer slots; the port's executor
(:func:`tpu_dist_nn_torch.parallel.one_f_one_b.run_schedule`) reads the
same tables' op order and issues each op on its slot's CUDA stream.

Wire model: an op finishing at tick ``t`` sends its result to the slot
of the chunk that consumes it: over the stage ring (``s -> s+1 mod S``
or ``s -> s-1 mod S``) or, when producer and consumer share a slot, the
self loopback; the payload is stored into a receive-buffer slot at the
START of tick ``t+1`` and consumed at any tick ``>= t+1``. Chunk 0
forwards read the input feed; chunk ``V-1`` backwards take their
cotangent from the loss tail.
"""

from __future__ import annotations

import dataclasses

import numpy as np

IDLE, FWD, BWD = 0, 1, 2
# Zero-bubble split backward (ZB-H1): BWD_B computes the INPUT gradient
# only (downstream stages wait for its dx); BWD_W computes the WEIGHT
# gradient, which nothing consumes, so the scheduler parks W ops in what
# would otherwise be bubble ticks.
BWD_B, BWD_W = 3, 4


@dataclasses.dataclass(frozen=True)
class ScheduleTables:
    """Dense ``[S, T]`` int32 tables of one schedule.

    ``op``: IDLE/FWD/BWD/BWD_B/BWD_W. ``chunk``: local chunk slot
    (0..v-1). ``mb``: microbatch id. ``stash``: input-stash slot —
    written by FWD, read and freed by BWD, read by BWD_B and freed by
    BWD_W. ``abuf_read``: fwd input slot (-1 = the input feed, chunk 0).
    ``gbuf_read``: bwd cotangent slot (-1 = the loss tail, chunk V-1),
    consumed by BWD or BWD_B. ``abuf_write``/``gbuf_write``:
    receive-buffer slot into which the incoming payload is stored at the
    START of this tick (-1 = nothing arrives; the fwd-ring and bwd-ring
    arrivals only). ``is_c0``: this bwd op belongs to global chunk 0.
    ``dy_stash``: cotangent-stash slot bridging a split backward — BWD_B
    writes the dy it consumed there, the matching BWD_W reads and frees
    it (-1 for every other op); ``dybuf_slots`` of them. ``send_rev``:
    0 = the op sends on its natural ring (fwd ops ``s -> s+1``, bwd ops
    ``s -> s-1``), 1 = on the opposite ring (the V shape's second leg),
    2 = on the self loopback (producer and consumer share a slot: the V
    shape's apex, or S = 1). The ``*ch_dst`` / ``*ch_slot`` tables say,
    per physical channel (fwd ring, bwd ring, self loopback), where an
    arrival is stored (-1 = nothing, 0 = abuf, 1 = gbuf) and at which
    slot: a slot can receive on all three in one tick. ``placement``:
    see the module docstring.
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
    dy_stash: np.ndarray
    dybuf_slots: int = 1
    placement: str = "megatron"

    def channel_tables(self) -> dict:
        """The six channel-major receive tables."""
        return {name: getattr(self, name) for name in (
            "fwdch_dst", "fwdch_slot", "bwdch_dst", "bwdch_slot",
            "selfch_dst", "selfch_slot")}

    def dev_of_chunk(self, c: int) -> int:
        """The stage slot that holds global chunk ``c``."""
        S = self.num_devices
        if self.placement == "megatron":
            return c % S
        if self.placement == "vshape":
            return c if c < S else 2 * S - 1 - c
        raise ValueError(f"unknown placement {self.placement!r}")

    def global_chunk(self, s: int, slot: int) -> int:
        """Inverse of (dev_of_chunk, slot): the global chunk index."""
        S = self.num_devices
        if self.placement == "megatron":
            return slot * S + s
        if self.placement == "vshape":
            return s if slot == 0 else 2 * S - 1 - s
        raise ValueError(f"unknown placement {self.placement!r}")

    @property
    def bubble_ticks(self) -> int:
        """Idle ticks beyond the per-slot work lower bound (the max
        non-idle op count over slots: 2*M*v for a combined-backward
        schedule, 3*M*v for a split-backward one)."""
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


def _emit_tables(cols: list, S: int, dev_fn=None) -> dict:
    """Convert the scheduler's per-tick op records into the ``[S, T]``
    int32 arrays (one pass shared by every build_* function). Record contract:
    ``op`` + (non-idle) ``c``/``f``; ``stash``,
    ``abuf_read``/``send_abuf_slot`` (FWD),
    ``gbuf_read``/``is_c0``/``send_gbuf_slot`` (BWD, BWD_B), ``dy_stash``
    (BWD_B writes, BWD_W reads). Sends land in the receiver's tables at
    tick ``t+1``. ``dev_fn`` maps a global chunk to its slot (default:
    the Megatron ``c % S``); a hop to the opposite ring or to the same
    slot lands in ``send_rev`` and the channel tables."""
    if dev_fn is None:
        dev_fn = lambda c: c % S  # noqa: E731
    T = len(cols)
    tables = {
        name: np.full((S, T), fill, dtype=np.int32)
        for name, fill in [
            ("op", IDLE), ("chunk", 0), ("mb", 0), ("stash", 0),
            ("abuf_read", -1), ("gbuf_read", -1),
            ("abuf_write", -1), ("gbuf_write", -1), ("is_c0", 0),
            ("dy_stash", -1), ("send_rev", 0),
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
                    rs = dev_fn(c + 1)
                    ch = _route(S, s, rs)
                    tables["send_rev"][s, t_i] = 2 if ch == 2 else (1 if ch == 1 else 0)
                    book(ch, s, rs, t_i + 1, 0, rec["send_abuf_slot"])
            elif op in (BWD, BWD_B):
                tables["gbuf_read"][s, t_i] = rec.get("gbuf_read", -1)
                tables["is_c0"][s, t_i] = rec.get("is_c0", 0)
                if op == BWD_B:
                    tables["dy_stash"][s, t_i] = rec["dy_stash"]
                if "send_gbuf_slot" in rec:
                    rs = dev_fn(c - 1)
                    ch = _route(S, s, rs)
                    tables["send_rev"][s, t_i] = 2 if ch == 2 else (1 if ch == 0 else 0)
                    book(ch, s, rs, t_i + 1, 1, rec["send_gbuf_slot"])
            else:  # BWD_W
                tables["dy_stash"][s, t_i] = rec["dy_stash"]
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


def _chunk_placement(placement: str, S: int, v: int):
    """``(dev, chunks_on)`` of a placement: the slot of global chunk
    ``c``, and each slot's chunks in ascending order."""
    if placement == "vshape":
        return (lambda c: c if c < S else 2 * S - 1 - c), [[s, 2 * S - 1 - s] for s in range(S)]
    return (lambda c: c % S), [list(range(s, S * v, S)) for s in range(S)]


def _build_split(S: int, v: int, M: int, placement: str, couple_w: bool,
                 name: str) -> ScheduleTables:
    """The greedy split-backward list-scheduler behind
    :func:`build_zero_bubble` and :func:`build_zb_v`: per slot, priority
    B > F > W (the input-gradient chain drains as fast as its
    dependencies allow, forwards keep the pipe full, weight gradients
    soak up idle ticks), except that a W backlog of ``S`` forces a W
    ahead of the next forward, which keeps the input stash (held F -> W)
    and the cotangent stash (held B -> W) O(S) instead of O(M).
    ``couple_w``: W runs the tick after its B (the control arm)."""
    V = S * v
    dev, chunks_on = _chunk_placement(placement, S, v)
    fwd_done = np.full((V, M), -1, dtype=np.int64)
    b_done = np.full((V, M), -1, dtype=np.int64)
    abuf_pool = [_SlotPool() for _ in range(S)]
    gbuf_pool = [_SlotPool() for _ in range(S)]
    stash_pool = [_SlotPool() for _ in range(S)]
    dybuf_pool = [_SlotPool() for _ in range(S)]
    abuf_slot: dict[tuple[int, int], int] = {}
    gbuf_slot: dict[tuple[int, int], int] = {}
    stash_slot: dict[tuple[int, int], int] = {}
    dybuf_slot: dict[tuple[int, int], int] = {}

    cols: list[list[dict]] = []
    next_fwd = [0] * V
    next_b = [0] * V
    w_queue: list[list[tuple[int, int]]] = [[] for _ in range(S)]  # B done, W pending
    done_ops = 0
    t = 0
    max_ticks = 6 * (M * v + V) + 16  # 3 ops a (chunk, microbatch)
    while done_ops < 3 * V * M:
        if t > max_ticks:
            raise RuntimeError(f"{name} schedule did not converge (S={S}, v={v}, M={M})")
        col = [dict(op=IDLE) for _ in range(S)]
        for s in range(S):
            chosen = None
            if couple_w and w_queue[s]:
                c, f = w_queue[s][0]
                chosen = dict(op=BWD_W, c=c, f=f)
            if chosen is None:
                # B first (critical path), deepest chunk first.
                for c in reversed(chunks_on[s]):
                    f = next_b[c]
                    if f >= M or f >= next_fwd[c]:
                        continue
                    if fwd_done[c, f] < 0 or fwd_done[c, f] >= t:
                        continue
                    if c < V - 1 and (b_done[c + 1, f] < 0 or b_done[c + 1, f] + 1 > t):
                        continue
                    chosen = dict(op=BWD_B, c=c, f=f)
                    break
            if chosen is None and len(w_queue[s]) >= S:
                c, f = w_queue[s][0]  # the memory guard
                chosen = dict(op=BWD_W, c=c, f=f)
            if chosen is None:
                # Forward: earliest microbatch, deepest ready chunk.
                best = None
                for c in chunks_on[s]:
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
            if chosen is None and w_queue[s]:
                c, f = w_queue[s][0]  # weight gradients fill the bubble
                chosen = dict(op=BWD_W, c=c, f=f)
            if chosen is not None:
                col[s] = chosen
        # Commit effects (the choices above read ticks < t only).
        for s in range(S):
            rec = col[s]
            if rec["op"] == IDLE:
                continue
            c, f = rec["c"], rec["f"]
            done_ops += 1
            if rec["op"] == FWD:
                slot = stash_pool[s].acquire()
                stash_slot[(c, f)] = slot
                rec["stash"] = slot
                if c > 0:
                    rslot = abuf_slot.pop((c, f))
                    rec["abuf_read"] = rslot
                    abuf_pool[s].release(rslot)
                fwd_done[c, f] = t
                next_fwd[c] = f + 1
                if c < V - 1:
                    wslot = abuf_pool[dev(c + 1)].acquire()
                    abuf_slot[(c + 1, f)] = wslot
                    rec["send_abuf_slot"] = wslot
            elif rec["op"] == BWD_B:
                rec["stash"] = stash_slot[(c, f)]  # read; W frees it
                dslot = dybuf_pool[s].acquire()
                dybuf_slot[(c, f)] = dslot
                rec["dy_stash"] = dslot
                if c < V - 1:
                    rslot = gbuf_slot.pop((c + 1, f))
                    rec["gbuf_read"] = rslot
                    gbuf_pool[s].release(rslot)
                b_done[c, f] = t
                next_b[c] = f + 1
                w_queue[s].append((c, f))
                rec["is_c0"] = int(c == 0)
                if c > 0:
                    wslot = gbuf_pool[dev(c - 1)].acquire()
                    gbuf_slot[(c, f)] = wslot
                    rec["send_gbuf_slot"] = wslot
            else:  # BWD_W
                w_queue[s].remove((c, f))
                slot = stash_slot.pop((c, f))
                rec["stash"] = slot
                stash_pool[s].release(slot)
                dslot = dybuf_slot.pop((c, f))
                rec["dy_stash"] = dslot
                dybuf_pool[s].release(dslot)
        cols.append(col)
        t += 1

    out = ScheduleTables(
        num_devices=S, num_chunks=V, num_microbatches=M, ticks=len(cols),
        abuf_slots=max(p.high for p in abuf_pool) or 1,
        gbuf_slots=max(p.high for p in gbuf_pool) or 1,
        stash_slots=max(p.high for p in stash_pool) or 1,
        dybuf_slots=max(p.high for p in dybuf_pool) or 1, placement=placement,
        **_emit_tables(cols, S, dev_fn=dev),
    )
    verify_tables(out)
    return out


def build_zero_bubble(num_devices: int, num_virtual: int, num_microbatches: int, *,
                      couple_w: bool = False) -> ScheduleTables:
    """Compile the ZB-H1 zero-bubble schedule on the Megatron placement:
    the backward split into BWD_B and BWD_W, W ops parked in what 1F1B
    leaves as bubble. At ``v = 1`` its bubble is ``S - 1`` ticks, half
    of 1F1B's ``2(S - 1)``, with the stashes O(S) (see
    :func:`_build_split`). ``couple_w=True`` builds the control: W the
    tick after its B, the same split accounting, so the bubble between
    the two is what decoupling W buys."""
    S, v, M = num_devices, num_virtual, num_microbatches
    if S < 1 or v < 1 or M < 1:
        raise ValueError(f"need S,v,M >= 1, got {S},{v},{M}")
    return _build_split(S, v, M, "megatron", couple_w, "zero-bubble")


def build_zb_v(num_devices: int, num_microbatches: int) -> ScheduleTables:
    """Compile the zero-bubble schedule on the V-shape placement (ZB-V):
    ``V = 2S`` chunks, chunk ``c`` on slot ``c`` for ``c < S`` and
    ``2S-1-c`` after the apex, so the forward runs down the slots and
    back up. The apex hand-off (chunk ``S-1`` -> ``S``) stays on its
    slot (the self loopback), the second leg rides the opposite ring,
    and chunk 0 (the embedding) and chunk ``V-1`` (the loss tail) share
    slot 0. Scheduled as :func:`build_zero_bubble`; its bubble is
    ``S - 1`` ticks whatever ``M``."""
    S, M = num_devices, num_microbatches
    if S < 1 or M < 1:
        raise ValueError(f"need S,M >= 1, got {S},{M}")
    return _build_split(S, 2, M, "vshape", False, "zb-v")


def verify_tables(tb: ScheduleTables, forward_only: bool = False) -> None:
    """Replay the tables with symbolic values; raise AssertionError on
    any flaw: a FWD that reads anything but its upstream chunk's output
    for its microbatch, a BWD or BWD_B that reads the wrong cotangent or
    stashed input, a BWD_W whose stashed input or parked cotangent is
    not its B's (or that runs before it), a receive or a park that
    clobbers a live slot, a send whose channel disagrees with
    ``send_rev``, or a (chunk, microbatch) that does not run forward
    (and, unless ``forward_only``, backward, or B and W) exactly once."""
    S, V, M, T = tb.num_devices, tb.num_chunks, tb.num_microbatches, tb.ticks
    chtb = tb.channel_tables()
    abuf = [dict() for _ in range(S)]   # slot -> symbolic value
    gbuf = [dict() for _ in range(S)]
    stash = [dict() for _ in range(S)]
    dybuf = [dict() for _ in range(S)]  # BWD_B -> BWD_W cotangent bridge
    sent: list[list] = [[None] * S for _ in range(3)]  # fwd ring, bwd ring, self
    fwd_count = np.zeros((V, M), dtype=int)
    bwd_count = np.zeros((V, M), dtype=int)
    b_count = np.zeros((V, M), dtype=int)
    w_count = np.zeros((V, M), dtype=int)

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
            elif op in (BWD, BWD_B):
                slot = int(tb.stash[s, t])
                # A combined backward frees its input; a split B only reads it.
                x = stash[s].pop(slot, None) if op == BWD else stash[s].get(slot)
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
                if op == BWD_B:
                    dslot = int(tb.dy_stash[s, t])
                    if dslot < 0:
                        raise AssertionError(f"t={t} s={s}: split B({c},{f}) has no dy_stash slot")
                    if dslot in dybuf[s]:
                        raise AssertionError(f"t={t} s={s}: dy_stash slot {dslot} clobbered")
                    dybuf[s][dslot] = ("dy", c, f)
                    b_count[c, f] += 1
                else:
                    bwd_count[c, f] += 1
                if c > 0:
                    place(s, c - 1, ("grad", c, f), natural=1)
            else:  # BWD_W
                x = stash[s].pop(int(tb.stash[s, t]), None)
                if x != ("x", c, f):
                    raise AssertionError(f"t={t} s={s}: W({c},{f}) stash read {x}")
                dy = dybuf[s].pop(int(tb.dy_stash[s, t]), None)
                if dy != ("dy", c, f):
                    raise AssertionError(f"t={t} s={s}: W({c},{f}) dy_stash read {dy}")
                if b_count[c, f] != 1:
                    raise AssertionError(f"t={t} s={s}: W({c},{f}) ran before its B")
                w_count[c, f] += 1
        sent = new_sent

    if not (fwd_count == 1).all():
        raise AssertionError("schedule did not run every (chunk, mb) FORWARD exactly once")
    if not forward_only:
        if b_count.any() or w_count.any():
            if bwd_count.any():
                raise AssertionError("schedule mixes combined and split backward")
            if not ((b_count == 1).all() and (w_count == 1).all()):
                raise AssertionError(
                    "split schedule did not run every (chunk, mb) B and W exactly once")
        elif not (bwd_count == 1).all():
            raise AssertionError("schedule did not run every (chunk, mb) BACKWARD exactly once")
    if any(abuf[s] for s in range(S)) or any(gbuf[s] for s in range(S)):
        raise AssertionError("unconsumed receive-buffer values at end")
    if any(stash[s] for s in range(S)):
        raise AssertionError("unconsumed stash values at end")
    if any(dybuf[s] for s in range(S)):
        raise AssertionError("unconsumed dy-stash values at end")
