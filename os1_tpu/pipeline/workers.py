"""Asynchronous pipeline orchestration: the reference's thread topology,
re-expressed for a host-orchestrated accelerator pipeline.

The reference runs LocalMapping and LoopClosing on their own threads fed by
keyframe queues (LocalMapping::Run LocalMapping.cc:46-110, queue
mlNewKeyFrames LocalMapping.h:406; LoopClosing::Run LoopClosing.cc:58-89,
queue mlpLoopKeyFrameQueue LoopClosing.h:280), so tracking never waits on
keyframe-rate work. Here the same topology is host threads that orchestrate
device programs:

  Tracker (caller thread)
    -> MappingWorker thread: BoW + cull + triangulate + fuse + local BA + KF cull
       -> LoopWorker thread: detect + Sim3 + correct (+ detached GBA)

Synchronization is ONE map lock (the reference's Map::mMutexMapUpdate,
Map.h:140): every store mutation and every host-side read of mutable store
state happens under it. Crucially the workers do NOT hold it while device
programs execute — they assemble inputs under the lock, dispatch, release,
block on the device, and re-take the lock to write back (exactly g2o's
optimize-outside / apply-under-mutex pattern, Optimizer.cc:516).

Control protocol parity:
  * SetAcceptKeyFrames backpressure (LocalMapping.cc:53,101) ->
    MappingWorker.accepting / Tracker.mapping_idle_fn;
  * InterruptBA / mbAbortBA preemption (LocalMapping.cc:116; Tracking.cc:755)
    -> LocalMapper.abort_ba checked between LM chunks;
  * RequestStop/isStopped/Release (LocalMapping.cc:479-553) -> request_stop/
    wait_stopped/release, used by loop correction and map save;
  * RequestReset (LocalMapping.cc:614-631) -> request_reset;
  * RequestFinish/isFinished (LocalMapping.cc:633-667) -> shutdown.
"""
from __future__ import annotations

import threading
from collections import deque


class MappingWorker:
    """LocalMapping thread: consumes a keyframe queue, runs the full local
    mapping pass per keyframe, then hands the keyframe to the loop worker."""

    def __init__(self, mapper, lock, on_process=None, on_pass_done=None,
                 loop_worker=None):
        self.mapper = mapper
        self.lock = lock
        self.on_process = on_process  # callback(kf) pre-pass (BoW + db.add)
        self.on_pass_done = on_pass_done  # callback(kf) post-pass (publish)
        self.loop_worker = loop_worker
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._finishing = False
        self._stop_requested = False
        self._stopped = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="LocalMapping"
        )
        self._thread.start()

    # ---------------- producer side (tracker thread) -------------------- #
    def insert_keyframe(self, kf: int, bootstrap: bool = False) -> None:
        """Queue a keyframe (LocalMapping::InsertKeyFrame, LocalMapping.cc:112:
        also sets mbAbortBA so a running local BA yields)."""
        with self._cv:
            self._queue.append((kf, bootstrap))
            self.mapper.abort_ba = True
            self._idle.clear()
            self._cv.notify()

    def interrupt_ba(self) -> None:
        """Tracking::NeedNewKeyFrame's InterruptBA (Tracking.cc:755)."""
        self.mapper.abort_ba = True

    @property
    def accepting(self) -> bool:
        """SetAcceptKeyFrames state (LocalMapping.cc:53,101). Slightly more
        eager than the reference's mono rule (strictly idle): up to one
        keyframe may queue behind the in-flight pass — map coverage must not
        stall for the heavy stages, which the mapper itself SKIPS while the
        queue is non-empty (the reference's CheckNewKeyFrames gates,
        LocalMapping.cc:72), so a queued keyframe still gets its points
        triangulated promptly."""
        with self._cv:
            return not self._stop_requested and len(self._queue) < 2

    def queue_size(self) -> int:
        with self._cv:
            return len(self._queue)

    # ---------------- control protocol ---------------------------------- #
    def request_stop(self) -> None:
        """Pause processing (keyframes stay queued) — loop correction and
        map save need the mapper quiescent (LoopClosing.cc:413-431,
        Osmap.cpp:70-73)."""
        with self._cv:
            self._stop_requested = True
            self.mapper.abort_ba = True
            self._cv.notify()

    def wait_stopped(self, timeout: float | None = None) -> bool:
        return self._stopped.wait(timeout)

    def release(self) -> None:
        """Resume after request_stop (LocalMapping::Release)."""
        with self._cv:
            self._stop_requested = False
            self._stopped.clear()
            self._cv.notify()

    def request_reset(self) -> None:
        """Drop all queued keyframes (LocalMapping::RequestReset); the
        in-flight pass (if any) finishes with its BA aborted."""
        with self._cv:
            self._queue.clear()
            self.mapper.abort_ba = True

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until the queue is drained and the current pass finished."""
        return self._idle.wait(timeout)

    def shutdown(self, timeout: float = 30.0) -> None:
        with self._cv:
            self._finishing = True
            self.mapper.abort_ba = True
            self._cv.notify()
        self._thread.join(timeout)

    # ---------------- worker loop ---------------------------------------- #
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._finishing and not self._stop_requested:
                    self._idle.set()
                    self._cv.wait()
                if self._finishing:
                    self._idle.set()
                    return
                if self._stop_requested:
                    self._stopped.set()
                    self._cv.wait()  # woken by release() (or shutdown)
                    continue
                kf, bootstrap = self._queue.popleft()
                self._idle.clear()
            try:
                self.mapper.abort_ba = False
                if self.on_process is not None:
                    self.on_process(kf)
                self.mapper.process(kf, bootstrap=bootstrap)
                if self.on_pass_done is not None:
                    self.on_pass_done(kf)
                if self.loop_worker is not None and not bootstrap:
                    self.loop_worker.insert_keyframe(kf)
            except Exception:  # noqa: BLE001 — a worker crash must surface
                import traceback

                traceback.print_exc()
            finally:
                with self._cv:
                    if not self._queue:
                        self._idle.set()


class CoopScheduler:
    """Cooperative mapping scheduler: the reference's LocalMapping +
    LoopClosing thread topology re-expressed as a DETERMINISTIC single-thread
    interleave for a host-orchestrated accelerator pipeline.

    Rationale: the mapper's per-stage work is device programs + small host
    bookkeeping; a worker THREAD buys no device
    overlap beyond what async dispatch already gives, but costs GIL/lock
    contention with the tracker on small hosts and makes the shipped
    configuration scheduler-dependent (accuracy varies run to run — the
    round-4 failure mode). Here each keyframe event is a generator
    (materialize + BoW -> cull -> triangulate -> fuse -> local BA chunks ->
    KF cull -> loop detect/Sim3/correct/GBA chunks) that yields at every
    dispatch->result boundary; the System steps it once per tracked frame.
    The device crunches a mapping stage while the host tracks the next
    frame — the reference's thread overlap (LocalMapping.cc:46-110,
    LoopClosing.cc:58-89) with the device as the only concurrency, so two
    runs produce bit-identical trajectories.

    Control-protocol parity (same table as the threaded workers):
    insert sets mbAbortBA (LocalMapping.cc:112); `accepting` is the
    SetAcceptKeyFrames backpressure; `clear` is RequestReset (epoch guards
    in the apply steps make the dropped in-flight event safe)."""

    def __init__(self, mapper, loop_steps=None, on_prepare=None,
                 on_pass_done=None):
        self.mapper = mapper
        self.loop_steps = loop_steps  # callable(kf) -> generator | None
        self.on_prepare = on_prepare  # callback(kf): materialize + BoW
        self.on_pass_done = on_pass_done  # callback(kf): publish mirror
        self._queue: deque = deque()
        self._active = None

    # ---------------- producer side (tracker FSM) ------------------------ #
    def insert(self, kf: int, bootstrap: bool = False) -> None:
        self._queue.append((kf, bootstrap))
        self.mapper.abort_ba = True  # a running local BA yields to the new KF

    @property
    def accepting(self) -> bool:
        """Backpressure: at most one keyframe may queue behind the active
        event (same rule as MappingWorker.accepting)."""
        return len(self._queue) < 2

    def queue_size(self) -> int:
        return len(self._queue)

    def busy(self) -> bool:
        return self._active is not None or bool(self._queue)

    # ---------------- scheduling ----------------------------------------- #
    def step(self, budget: int = 1) -> None:
        """Advance the active event by up to `budget` steps (one step = one
        dispatch->result interval). Called once per tracked frame."""
        for _ in range(budget):
            if self._active is None:
                if not self._queue:
                    return
                kf, bootstrap = self._queue.popleft()
                self.mapper.abort_ba = False
                self._active = self._event(kf, bootstrap)
            try:
                next(self._active)
            except StopIteration:
                self._active = None

    def drain(self) -> None:
        """Run every queued event to completion (flush / mode switch)."""
        while self._active is not None or self._queue:
            self.step()

    def clear(self) -> None:
        """RequestReset: drop queued events and the in-flight one (its
        remaining applies are epoch-guarded no-ops anyway)."""
        self._queue.clear()
        self._active = None

    def _event(self, kf: int, bootstrap: bool):
        if self.on_prepare is not None:
            self.on_prepare(kf)
        yield from self.mapper.process_steps(kf, bootstrap=bootstrap)
        if self.on_pass_done is not None:
            self.on_pass_done(kf)
        if self.loop_steps is not None and not bootstrap:
            yield from self.loop_steps(kf)


class LoopWorker:
    """LoopClosing thread: consumes keyframes already processed by local
    mapping and attempts loop detection/closure on each."""

    def __init__(self, process, lock):
        self.process = process  # callback(kf) -> bool (closed a loop)
        self.lock = lock
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._finishing = False
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="LoopClosing"
        )
        self._thread.start()

    def insert_keyframe(self, kf: int) -> None:
        with self._cv:
            self._queue.append(kf)
            self._idle.clear()
            self._cv.notify()

    def request_reset(self) -> None:
        with self._cv:
            self._queue.clear()

    def wait_idle(self, timeout: float | None = None) -> bool:
        return self._idle.wait(timeout)

    def shutdown(self, timeout: float = 30.0) -> None:
        with self._cv:
            self._finishing = True
            self._cv.notify()
        self._thread.join(timeout)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._finishing:
                    self._idle.set()
                    self._cv.wait()
                if self._finishing:
                    self._idle.set()
                    return
                kf = self._queue.popleft()
                self._idle.clear()
            try:
                self.process(kf)
            except Exception:  # noqa: BLE001
                import traceback

                traceback.print_exc()
            finally:
                with self._cv:
                    if not self._queue:
                        self._idle.set()
