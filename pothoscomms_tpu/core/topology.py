"""Topology: block graph + cooperative streaming executor.

Equivalent of ``Pothos::Topology`` plus the scheduler loop of the
Pothos core framework (reference: every test builds one, e.g.
filter/TestFIRDesigner.cpp:147-178 — connect, commit, waitInactive).

Differences from the reference (deliberate):

- The reference runs one actor thread per block; we run a single-threaded
  cooperative loop. Device throughput does not come from host threads — it
  comes from the functional cores being fused/jitted; the executor only
  moves host-side buffers and control messages between device calls. For
  the high-rate path, chains of blocks are compiled into ONE jitted program
  by the fused-chain compiler (pothoscomms_tpu/parallel/), so the executor
  granularity is irrelevant to hot-loop performance.
- Backpressure: the reference uses bounded buffer managers; every edge
  here has a per-port element/message capacity (InputPort.capacity) that
  gates upstream scheduling, plus per-port ``reserve`` gating and
  production quotas for unbounded sources.
"""

from __future__ import annotations

import time
from typing import List, Tuple

from pothoscomms_tpu.core.block import Block


class Topology:
    def __init__(self, name: str = "topology"):
        self.name = name
        self.blocks: List[Block] = []
        self._committed = False
        # Auto-fusion (core/fusion.py): linear runs of device-core
        # blocks execute as ONE jitted program once the head edge
        # backlog crosses fuse_threshold elements. None disables.
        self.auto_fuse = True
        self.fuse_threshold: int = 1 << 16
        self._segments: List = []
        self._seg_by_block: dict = {}

    # ------------------------------------------------------------------ #
    # Graph construction
    # ------------------------------------------------------------------ #
    def _register(self, blk: Block) -> None:
        if blk not in self.blocks:
            self.blocks.append(blk)
            blk._topology = self

    def connect(self, src: Block, src_port, dst: Block, dst_port) -> None:
        """Connect a stream edge or a signal→slot edge.

        If ``src_port`` names a registered signal of ``src``, the edge is a
        signal/slot wire (reference: filter/TestFIRDesigner.cpp:173
        ``connect(designer, "tapsChanged", filter, "setTaps")``); otherwise
        it is a stream edge between output and input ports.
        """
        self._register(src)
        self._register(dst)
        sname = str(src_port)
        if sname in src._signals:
            src.connect_signal(sname, dst, str(dst_port))
            return
        out = src.output(sname)
        inp = dst.input(str(dst_port))
        if out.dtype is not None and inp.dtype is not None:
            if out.dtype.np != inp.dtype.np or out.dtype.storage_shape_suffix != inp.dtype.storage_shape_suffix:
                raise ValueError(
                    f"dtype mismatch on {src.name}[{sname}] ({out.dtype}) -> "
                    f"{dst.name}[{dst_port}] ({inp.dtype})"
                )
        out.connect(inp)

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #
    def commit(self) -> None:
        """Activate all blocks (reference: Topology::commit()).

        Signal emissions during activate() are deferred until every block
        has activated — matching Pothos, where slot calls are queued into
        the receiving block's actor and run after topology commit. (A
        designer emitting "tapsChanged" inside activate must not have the
        taps clobbered by the receiving filter's own later activate(),
        e.g. the waitTaps re-arm in filter/FIRFilter.cpp:201-205.)
        """
        if self._committed:
            return
        deferred: List[tuple] = []
        for blk in self.blocks:
            blk._active = True
        for blk in self.blocks:
            blk._emit_queue = deferred
            blk.activate()
        for blk in self.blocks:
            blk._emit_queue = None
        for blk, name, args in deferred:
            blk.emit_signal(name, *args)
        if self.auto_fuse:
            from pothoscomms_tpu.core.fusion import detect_segments

            self._segments = detect_segments(self.blocks, self)
        self._seg_by_block = {
            id(b): seg for seg in self._segments for b in seg.blocks
        }
        self._committed = True

    def uncommit(self) -> None:
        if self._committed:
            for seg in self._segments:
                seg.disengage()
            for blk in self.blocks:
                blk.deactivate()
                blk._active = False
            self._committed = False

    def __enter__(self):
        self.commit()
        return self

    def __exit__(self, *exc):
        self.uncommit()

    # ------------------------------------------------------------------ #
    # Execution
    # ------------------------------------------------------------------ #
    def _state_fingerprint(self) -> Tuple[int, ...]:
        # total_popped is monotonic so a message posted and popped within
        # one round registers as progress; the pending count catches a
        # message still waiting for a block earlier in the schedule
        consumed = produced = msgs = pending = quota = 0
        for blk in self.blocks:
            quota += blk._source_quota
            for p in blk.inputs.values():
                consumed += p.total_consumed
                msgs += p.total_popped
                pending += len(p._messages)
            for o in blk.outputs.values():
                produced += o.total_produced
        return (consumed, produced, msgs, pending, quota)

    def _run_once(self) -> bool:
        """One scheduling round over all blocks; True if any progress.

        Blocks belonging to an ENGAGED fused segment are executed by
        the segment (one jitted step per round) instead of their own
        work(); disengaged segments' members run normally. After the
        round, segments whose head backlog crossed the threshold
        engage; when the graph would otherwise report quiescence with
        engaged segments still holding sub-quantum data, they
        disengage so the streaming path drains the remainder."""
        before = self._state_fingerprint()
        for blk in self.blocks:
            seg = self._seg_by_block.get(id(blk))
            if seg is not None:
                if seg.blocks[0] is blk:
                    # engagement checked at the head's schedule slot so
                    # a fresh backlog goes fused in the same round
                    if (not seg.engaged and self.fuse_threshold is not None
                            and seg.backlog() >= self.fuse_threshold):
                        seg.try_engage()
                    if seg.engaged:
                        t0 = time.perf_counter()
                        seg.work()
                        if not seg.engaged:
                            # disengaged mid-slot. Reconfig (epoch
                            # bump): re-engage right away with rebuilt
                            # cores; labels: engagement is blocked (or
                            # label-limited), so fall through and let
                            # the head stream the labeled region now.
                            if (self.fuse_threshold is not None
                                    and seg.backlog()
                                    >= self.fuse_threshold):
                                seg.try_engage()
                            if seg.engaged:
                                seg.work()
                        blk._work_time += time.perf_counter() - t0
                        blk._work_calls += 1
                        if seg.engaged:
                            continue
                elif seg.engaged:
                    continue  # member executed by its segment
            if not blk.wants_work() or blk.downstream_congested():
                continue
            for p in blk.inputs.values():
                p._consumed_this_work = 0
            for o in blk.outputs.values():
                o._produced_this_work = 0
            t0 = time.perf_counter()
            blk.work()
            blk._work_time += time.perf_counter() - t0
            blk._work_calls += 1
        # return any backlog a segment withheld from a label-bounded
        # streaming drain — same round, so it stays the newest data in
        # the head queue (order-correct append)
        for seg in self._segments:
            if seg.stash is not None:
                for part in seg.stash:
                    seg.head.push_buffer(part)
                seg.stash = None
        # LOAD-INDEPENDENT timer delivery: fire due timers every round,
        # not only at quiescence — the reference LLC's monitor thread
        # ticks every 1 ms regardless of scheduler load
        # (mac/SimpleLlc.cpp:140-162); without this, sustained streaming
        # starves ARQ retransmission indefinitely.
        now = None
        for blk in self.blocks:
            ntd = getattr(blk, "next_timer_deadline", None)
            if ntd is None:
                continue
            deadline = ntd()
            if deadline is None:
                continue
            if now is None:
                now = time.monotonic()
            if deadline <= now:
                blk.poll_timers()
        progressed = self._state_fingerprint() != before
        if not progressed:
            for seg in self._segments:
                if seg.engaged and seg.backlog() > 0:
                    # stream drained below one quantum: fold state back
                    # so the streaming path finishes the remainder. A
                    # segment whose head is EMPTY stays engaged across
                    # quiescence — its state lives in the device carry
                    # and the next backlog resumes fused directly
                    # (avoiding an import/export round trip that would
                    # also shift every later queue boundary by K-1 and
                    # force fresh slice-program compiles).
                    seg.disengage()
                    progressed = True
        return progressed

    def wait_inactive(self, timeout: float = 10.0, idle: float = 0.0) -> bool:
        """Run the graph to quiescence (reference: Topology::waitInactive,
        used as the universal test completion barrier —
        math/TestArithmeticBlocks.cpp:538).

        Returns True if the graph became idle within the timeout.

        ``timeout`` bounds the time spent *without forward progress* — a
        scheduling round that consumed/produced data resets the deadline.
        (Wall-clock would be wrong: the first work() of each block
        blocks on XLA compilation, which can exceed any reasonable idle
        timeout; that is activity, not quiescence.)
        """
        self.commit()
        deadline = time.monotonic() + timeout
        while True:
            progressed = self._run_once()
            if progressed:
                deadline = time.monotonic() + timeout
                continue
            # give timer-driven blocks (e.g. LLC monitor) a chance
            fired = any(
                getattr(blk, "poll_timers", lambda: False)()
                for blk in self.blocks
            )
            if not fired:
                return True
            if time.monotonic() > deadline:
                return False
            # Timers are pending but nothing fired yet: sleep until the
            # nearest declared timer deadline instead of busy-spinning
            # (the reference's monitor thread sleeps 1 ms per tick,
            # mac/SimpleLlc.cpp:140-162). A pending message means the
            # next round will progress, so only sleep when idle.
            if not self._state_fingerprint()[3]:
                deadlines = [
                    d for blk in self.blocks
                    for d in (getattr(blk, "next_timer_deadline",
                                      lambda: None)(),)
                    if d is not None
                ]
                if deadlines:
                    time.sleep(min(
                        max(min(deadlines) - time.monotonic(), 0.0), 0.05
                    ))

    # ------------------------------------------------------------------ #
    # Observability + checkpointing (core/introspect.py)
    # ------------------------------------------------------------------ #
    def query_stats(self) -> dict:
        """Per-block runtime stats (Pothos queryJSONStats equivalent)."""
        from pothoscomms_tpu.core.introspect import query_stats

        return query_stats(self)

    def save_state(self, path: str) -> None:
        """Checkpoint all block carry state + queued port data."""
        from pothoscomms_tpu.core.introspect import save_state

        # fused carries live in the segments; fold them back into the
        # blocks' streaming state so the checkpoint is self-contained
        for seg in self._segments:
            seg.disengage()
        save_state(self, path)

    def load_state(self, path: str) -> None:
        from pothoscomms_tpu.core.introspect import load_state

        # mirror save_state: an engaged segment holds stream state in
        # device carries; restoring underneath it would leave the stale
        # carries to be imported on a later disengage, corrupting the
        # freshly loaded queues
        for seg in self._segments:
            seg.disengage()
        load_state(self, path)

    def run_source_elements(self, n: int) -> None:
        """Grant every unbounded source a quota of ~n elements, then run to
        quiescence. This is how tests drive waveform/noise sources, standing
        in for the reference's free-running scheduler + sleep pattern
        (reference: filter/TestFIRFilter.cpp:19-59)."""
        self.commit()
        for blk in self.blocks:
            if blk.unbounded_source:
                blk._source_quota = n
        self.wait_inactive()
