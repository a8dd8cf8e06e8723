"""Asyncio streaming front-end over N ``ServingEngine`` replicas (the
port's counterpart of ``repro/frontend/server.py``).

Stdlib only (``asyncio.start_server`` + JSON lines) — the point is the
serving architecture, not an HTTP framework:

* One ``EngineReplica`` per engine, each with a DEDICATED step-loop
  thread.  The engine is single-threaded by contract (fslint FS006
  enforces it inside the engine); the replica thread is the only code
  that ever touches it.  The asyncio side talks to a replica through a
  call queue — ``EngineReplica.call`` returns a
  ``concurrent.futures.Future`` which coroutines consume via
  ``asyncio.wrap_future`` (never ``.result()`` — FS007 flags blocking
  calls on the event loop, and this server must pass its own lint).
* New sessions funnel through the ``FairAdmissionQueue``; a single
  dispatcher coroutine pops in VTC order, routes with least-predicted
  TTFT (``Router``), and charges the client's counter only on a
  SUCCESSFUL engine submit.  Follow-up turns skip queueing (their KV is
  resident — making them wait would throw the reuse copy's value away)
  but still bill their decode tokens, so a chatty session keeps paying.
* Backpressure ladder (DESIGN.md §11): admission queue at capacity ->
  429 refusal at the door; engine ``EngineOverloadError`` at dispatch ->
  silent requeue-front (the client keeps its position, pays nothing);
  ``drain`` -> 503 for everything new while in-flight work finishes.
* A client disconnect aborts every live request it owns, releases its
  parked sessions and purges its queued tickets — a dead socket must
  not hold GPU blocks.

* On CUDA every replica's step-loop thread issues its eager work on the
  device's default stream, as any thread of the process does, and the
  replicas share one parameter bundle (each engine owns its pools).  A
  replica captures its decode-step graphs on its runner's own side
  stream in thread-local capture mode
  (``core/decode_runner.py::_StepGraph``), so another replica's launches,
  synchronisations and allocations during that capture neither join the
  graph nor invalidate it.  Kernel launch counts are summed over the
  process, and also kept per pool (``kernels.launches.on``).

Protocol: newline-delimited JSON, one object per line, both ways.
Client ops: ``submit``, ``continue``, ``abort``, ``release``,
``drain``.  Server events: ``accepted``, ``token``, ``finish``,
``drained``, ``error`` (with an HTTP-ish ``code``).
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import json
import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.faults import EngineDrainingError, EngineOverloadError
from repro_torch.core.request_api import SamplingParams, SLOSpec
from repro_torch.core.serving import ServingEngine
from repro_torch.frontend.admission import (FairAdmissionQueue,
                                            QueueFullError, slo_priority)
from repro_torch.frontend.router import Router

_STOP = object()


class EngineReplica:
    """One engine + its step-loop thread.  All engine access happens on
    that thread: coroutines enqueue closures via ``call`` and await the
    returned future.  Between calls the thread steps the engine while it
    has work, publishes a fresh ``load_snapshot`` (plain dict ref-swap —
    readers on any thread see a coherent sample) and hands each step's
    outputs to the asyncio loop via ``call_soon_threadsafe``."""

    def __init__(self, index: int, engine: ServingEngine,
                 loop: asyncio.AbstractEventLoop, on_outputs):
        self.index = index
        self.engine = engine
        self._loop = loop
        self._on_outputs = on_outputs      # fn(index, outputs), runs on loop
        self._calls: _queue.Queue = _queue.Queue()
        self._snapshot: Dict[str, object] = engine.load_snapshot()
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name=f"replica-{index}", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stopped = True
        self._calls.put(_STOP)
        self._thread.join(timeout=10.0)
        # cancel any call that raced in behind the sentinel — an
        # awaiter must never block on a thread that has exited
        while True:
            try:
                item = self._calls.get_nowait()
            except _queue.Empty:
                break
            if item is not _STOP:
                item[0].cancel()

    def snapshot(self) -> Dict[str, object]:
        return self._snapshot

    def call(self, fn, *args, **kwargs) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if self._stopped:
            fut.cancel()
            return fut
        self._calls.put((fut, fn, args, kwargs))
        return fut

    # -- step-loop thread --------------------------------------------------

    def _drain_calls(self, block: bool) -> bool:
        """Run every queued call (admission/abort beats stepping).
        Returns False when the stop sentinel arrived."""
        first = True
        while True:
            try:
                if block and first:
                    item = self._calls.get(timeout=0.02)
                else:
                    item = self._calls.get_nowait()
            except _queue.Empty:
                return True
            first = False
            if item is _STOP:
                return False
            fut, fn, args, kwargs = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                res = fn(*args, **kwargs)
            except BaseException as e:           # delivered to the awaiter
                fut.set_exception(e)
            else:
                # publish the post-call snapshot BEFORE resolving, so an
                # awaiter's next routing decision sees this call's load
                self._snapshot = self.engine.load_snapshot()
                fut.set_result(res)

    def _run(self) -> None:
        while True:
            idle = not self.engine.has_work()
            if not self._drain_calls(block=idle):
                break
            if self.engine.has_work():
                outs = self.engine.step()
                if outs and self._on_outputs is not None:
                    self._loop.call_soon_threadsafe(
                        self._on_outputs, self.index, outs)
            self._snapshot = self.engine.load_snapshot()
            # hand the GIL over between steps: a step that never waits
            # (sim mode, or a CPU replica) would otherwise hold it for
            # whole switch intervals, and the event loop (streaming,
            # admission, aborts) would fall steps behind its replicas
            time.sleep(0)


@dataclass
class _Session:
    handle: int
    client: str
    conn: "_Conn"
    retain: bool
    live: bool = False        # a turn is in flight on the engine
    parked: bool = False      # finished + retained, awaiting follow-up


@dataclass
class _Ticket:
    """One queued ``submit`` awaiting fair dispatch."""
    handle: int
    conn: "_Conn"
    req_id: Optional[object]
    prompt: object
    sampling: SamplingParams
    slo: Optional[SLOSpec]
    retain: bool

    def prompt_tokens(self) -> int:
        return self.prompt if isinstance(self.prompt, int) else len(self.prompt)


@dataclass
class _Conn:
    writer: asyncio.StreamWriter
    client: str = "anon"
    handles: Set[int] = field(default_factory=set)
    sendq: "asyncio.Queue[Optional[bytes]]" = field(
        default_factory=asyncio.Queue)
    closed: bool = False

    def send(self, obj: Dict[str, object]) -> None:
        """Queue one JSON line (callable from loop callbacks — the
        sender task owns the actual socket writes + drain)."""
        if not self.closed:
            self.sendq.put_nowait(
                json.dumps(obj, separators=(",", ":")).encode() + b"\n")


class FrontendServer:
    """Owns the replicas, the fair queue, the router and the listener.

    ``engines`` are fully-constructed ``ServingEngine``s (the caller
    wires event sinks — e.g. one JSONL file per replica, written only
    from that replica's thread, so the logs need no locking).  Construct
    it inside the event loop that will serve it (a coroutine run by
    ``asyncio.run``)."""

    def __init__(self, engines: List[ServingEngine], *,
                 host: str = "127.0.0.1", port: int = 0,
                 admission_capacity: int = 256,
                 weights: Optional[Dict[str, float]] = None,
                 migrate_threshold: int = 4,
                 rebalance_period_s: float = 0.05):
        self.host, self.port = host, port
        self.loop = asyncio.get_running_loop()
        self.queue = FairAdmissionQueue(capacity=admission_capacity,
                                        weights=weights)
        self.router = Router(len(engines), migrate_threshold=migrate_threshold)
        self.replicas = [EngineReplica(i, e, self.loop, self._on_outputs)
                         for i, e in enumerate(engines)]
        self.sessions: Dict[int, _Session] = {}
        self._next_handle = 0
        self._kick = asyncio.Event()
        self._migrating: Dict[int, asyncio.Event] = {}
        self._busy: Set[int] = set()       # follow-up dispatch in flight
        self._draining = False
        self._drain_waiters: List[_Conn] = []
        self._rebalance_period_s = rebalance_period_s
        self._server: Optional[asyncio.AbstractServer] = None
        self._tasks: List[asyncio.Task] = []
        self._conn_tasks: Set[asyncio.Task] = set()

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> Tuple[str, int]:
        for r in self.replicas:
            r.start()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self._tasks.append(asyncio.ensure_future(self._dispatcher()))
        self._tasks.append(asyncio.ensure_future(self._rebalancer()))
        sock = self._server.sockets[0]
        self.host, self.port = sock.getsockname()[:2]
        return self.host, self.port

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        if self._server is not None:
            self._server.close()          # stop listening
        # cancel and await the connection handlers BEFORE waiting for the
        # listener and stopping the replicas: from Python 3.12 on
        # ``wait_closed`` waits for every connection, so a client still
        # connected would hang it, and the handlers' disconnect cleanup
        # (abort/release engine calls) needs live step-loop threads
        for t in list(self._conn_tasks):
            t.cancel()
        for t in list(self._conn_tasks):
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        if self._server is not None:
            await self._server.wait_closed()
        for r in self.replicas:
            r.stop()

    # -- token/finish fan-out (loop thread, via call_soon_threadsafe) ------

    def _on_outputs(self, index: int, outs) -> None:
        for out in outs:
            sess = self.sessions.get(out.handle)
            if sess is None:
                continue
            if out.new_tokens > 0:
                self.queue.feedback(sess.client, out.new_tokens)
                ev: Dict[str, object] = {
                    "event": "token", "handle": out.handle,
                    "new_tokens": out.new_tokens, "generated": out.generated,
                }
                if out.token_ids is not None:
                    ev["token_ids"] = list(out.token_ids)
                if out.first_token:
                    ev["first"] = True
                sess.conn.send(ev)
            if out.finished:
                sess.live = False
                self.queue.done(sess.client)
                retained = sess.retain and out.finish_reason in ("length",
                                                                 "stop")
                sess.parked = retained
                sess.conn.send({
                    "event": "finish", "handle": out.handle,
                    "reason": out.finish_reason, "generated": out.generated,
                    "retained": retained,
                })
                if not retained:
                    self._forget(sess)

    def _forget(self, sess: _Session) -> None:
        self.sessions.pop(sess.handle, None)
        sess.conn.handles.discard(sess.handle)
        self.router.release(sess.handle)

    # -- fair dispatch -----------------------------------------------------

    async def _dispatcher(self) -> None:
        while True:
            await self._kick.wait()
            self._kick.clear()
            while True:
                popped = self.queue.pop()
                if popped is None:
                    break
                client, ticket = popped
                if ticket.conn.closed:
                    self.queue.done(client)
                    self.router.release(ticket.handle)
                    continue
                snaps = [r.snapshot() for r in self.replicas]
                try:
                    idx = self.router.route_new(ticket.handle, snaps)
                except RuntimeError:           # every replica draining
                    self.queue.done(client)
                    self._refuse(ticket, 503, "all replicas draining")
                    continue
                rep = self.replicas[idx]
                try:
                    await asyncio.wrap_future(rep.call(
                        rep.engine.add_request, ticket.prompt,
                        ticket.sampling, slo=ticket.slo,
                        handle=ticket.handle, retain_kv=ticket.retain,
                        priority=slo_priority(ticket.slo)))
                except EngineOverloadError:
                    # not a refusal: requeue at the front, uncharged, and
                    # let in-flight work drain before trying again
                    self.router.release(ticket.handle)
                    self.queue.requeue(client, ticket)
                    await asyncio.sleep(0.02)
                    self._kick.set()
                    break
                except EngineDrainingError:
                    self.queue.done(client)
                    self.router.release(ticket.handle)
                    self._refuse(ticket, 503, "replica draining")
                    continue
                except ValueError as e:
                    # a request the engine can never serve (a token count
                    # sent to a real replica, bad sampling): refuse it
                    # rather than let the dispatcher die
                    self.queue.done(client)
                    self.router.release(ticket.handle)
                    self._refuse(ticket, 400, str(e))
                    continue
                self.queue.charge(client, ticket.prompt_tokens())
                sess = self.sessions.get(ticket.handle)
                if sess is None:
                    # owner disconnected while the submit was in flight;
                    # the engine accepted it, so take it back out
                    await asyncio.wrap_future(rep.call(
                        rep.engine.abort, ticket.handle))
                    self.queue.done(client)
                    self.router.release(ticket.handle)
                    continue
                sess.live = True
                ticket.conn.send({"event": "accepted", "id": ticket.req_id,
                                  "handle": ticket.handle, "replica": idx})

    def _refuse(self, ticket: _Ticket, code: int, msg: str) -> None:
        self.sessions.pop(ticket.handle, None)
        ticket.conn.handles.discard(ticket.handle)
        ticket.conn.send({"event": "error", "id": ticket.req_id,
                          "code": code, "message": msg})

    # -- rebalancing -------------------------------------------------------

    async def _rebalancer(self) -> None:
        while True:
            await asyncio.sleep(self._rebalance_period_s)
            if self._draining:
                self._check_drained()
                continue
            snaps = [r.snapshot() for r in self.replicas]
            busy = self._busy | set(self._migrating)
            for handle, src, dst in self.router.plan_migrations(snaps, busy):
                await self.migrate(handle, dst)

    async def migrate(self, handle: int, dst: int) -> Optional[Dict]:
        """Move one PARKED session to replica ``dst`` through
        ``export_session`` / ``import_session`` (the rebalancer's move,
        also callable on its own).  Follow-ups, aborts and releases of the
        handle wait for the move.  Returns the payload shipped, or None
        where the session was not movable (gone, live, mid-dispatch,
        already home) or ``dst`` refused it and it went back home."""
        sess = self.sessions.get(handle)
        src = self.router.affinity.get(handle)
        if sess is None or not sess.parked or handle in self._busy \
                or handle in self._migrating or src is None or src == dst:
            return None
        gate = self._migrating[handle] = asyncio.Event()
        try:
            try:
                payload = await asyncio.wrap_future(
                    self.replicas[src].call(
                        self.replicas[src].engine.export_session, handle))
            except KeyError:
                return None    # session left between planning and export
            try:
                await asyncio.wrap_future(self.replicas[dst].call(
                    self.replicas[dst].engine.import_session, payload))
                self.router.note_migrated(handle, dst)
                return payload
            except (EngineDrainingError, ValueError):
                # dst refused: put the session back home (src just
                # exported it, so the handle is free there again)
                await asyncio.wrap_future(self.replicas[src].call(
                    self.replicas[src].engine.import_session, payload))
                return None
        finally:
            del self._migrating[handle]
            gate.set()

    def _check_drained(self) -> None:
        if not self._drain_waiters:
            return
        if self.queue.depth() > 0:
            return
        for r in self.replicas:
            s = r.snapshot()
            if Router._load(s) > 0:
                return
        for conn in self._drain_waiters:
            conn.send({"event": "drained"})
        self._drain_waiters = []

    # -- per-connection protocol -------------------------------------------

    async def _sender(self, conn: _Conn) -> None:
        try:
            while True:
                buf = await conn.sendq.get()
                if buf is None:
                    break
                conn.writer.write(buf)
                await conn.writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        conn = _Conn(writer=writer)
        sender = asyncio.ensure_future(self._sender(conn))
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    msg = json.loads(line)
                except ValueError:
                    conn.send({"event": "error", "code": 400,
                               "message": "bad json"})
                    continue
                await self._handle_msg(conn, msg)
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            if task is not None:
                self._conn_tasks.discard(task)
            conn.closed = True
            await self._on_disconnect(conn)
            conn.sendq.put_nowait(None)
            sender.cancel()
            try:
                await sender
            except asyncio.CancelledError:
                pass
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @staticmethod
    def _parse_sampling(msg: Dict[str, object]) -> SamplingParams:
        return SamplingParams(
            max_tokens=int(msg.get("max_tokens", 16)),
            temperature=msg.get("temperature"),
            top_k=msg.get("top_k"), top_p=msg.get("top_p"),
            stop_token_ids=tuple(msg.get("stop_token_ids") or ()))

    @staticmethod
    def _parse_slo(msg: Dict[str, object]) -> Optional[SLOSpec]:
        slo = msg.get("slo")
        if not isinstance(slo, dict):
            return None
        return SLOSpec(ttft_ms=slo.get("ttft_ms"), tbt_ms=slo.get("tbt_ms"))

    async def _handle_msg(self, conn: _Conn, msg: Dict[str, object]) -> None:
        op = msg.get("op")
        rid = msg.get("id")
        if op == "submit":
            if self._draining:
                conn.send({"event": "error", "id": rid, "code": 503,
                           "message": "draining"})
                return
            conn.client = str(msg.get("client", conn.client))
            handle = self._next_handle
            self._next_handle += 1
            ticket = _Ticket(
                handle=handle, conn=conn, req_id=rid,
                prompt=msg["prompt"], sampling=self._parse_sampling(msg),
                slo=self._parse_slo(msg),
                retain=bool(msg.get("retain", True)))
            self.sessions[handle] = _Session(
                handle=handle, client=conn.client, conn=conn,
                retain=ticket.retain)
            conn.handles.add(handle)
            try:
                self.queue.push(conn.client, ticket)
            except QueueFullError as e:
                self.sessions.pop(handle, None)
                conn.handles.discard(handle)
                conn.send({"event": "error", "id": rid, "code": 429,
                           "message": str(e), "queue_depth": e.queue_depth})
                return
            self._kick.set()
        elif op == "continue":
            await self._handle_continue(conn, msg, rid)
        elif op == "abort":
            await self._handle_abort(conn, int(msg["handle"]))
        elif op == "release":
            await self._handle_release(conn, int(msg["handle"]))
        elif op == "drain":
            self._draining = True
            for r in self.replicas:
                await asyncio.wrap_future(r.call(r.engine.drain))
            self._drain_waiters.append(conn)
            self._check_drained()
        else:
            conn.send({"event": "error", "id": rid, "code": 400,
                       "message": f"unknown op {op!r}"})

    async def _handle_continue(self, conn: _Conn, msg: Dict[str, object],
                               rid) -> None:
        handle = int(msg["handle"])
        sess = self.sessions.get(handle)
        if sess is None or sess.conn is not conn or not sess.parked:
            conn.send({"event": "error", "id": rid, "code": 400,
                       "message": f"handle {handle} not continuable"})
            return
        # a rebalance may be moving this session between replicas —
        # follow-ups wait for the move, then route to the new home
        gate = self._migrating.get(handle)
        if gate is not None:
            await gate.wait()
        self._busy.add(handle)
        try:
            idx = self.router.route_followup(handle)
            rep = self.replicas[idx]
            slo = self._parse_slo(msg)
            prompt = msg["prompt"]
            try:
                await asyncio.wrap_future(rep.call(
                    rep.engine.continue_session, handle, prompt,
                    self._parse_sampling(msg), slo=slo,
                    retain_kv=bool(msg.get("retain", True)),
                    priority=slo_priority(slo)))
            except (EngineDrainingError, EngineOverloadError, KeyError,
                    ValueError) as e:
                code = (503 if isinstance(e, EngineDrainingError)
                        else 400 if isinstance(e, ValueError) else 429)
                conn.send({"event": "error", "id": rid, "handle": handle,
                           "code": code, "message": str(e)})
                return
            # follow-ups skip the fair queue (their KV is resident) but
            # still bill the prompt so chatty sessions keep paying
            ntok = prompt if isinstance(prompt, int) else len(prompt)
            self.queue.begin(sess.client)
            self.queue.charge(sess.client, ntok)
            sess.parked = False
            sess.live = True
            conn.send({"event": "accepted", "id": rid, "handle": handle,
                       "replica": idx})
        finally:
            self._busy.discard(handle)

    async def _handle_abort(self, conn: _Conn, handle: int) -> None:
        sess = self.sessions.get(handle)
        if sess is None or sess.conn is not conn:
            return
        gate = self._migrating.get(handle)
        if gate is not None:
            await gate.wait()
        idx = self.router.affinity.get(handle)
        acked = False
        if idx is not None:
            rep = self.replicas[idx]
            acked = await asyncio.wrap_future(
                rep.call(rep.engine.abort, handle))
        if sess.live:
            self.queue.done(sess.client)
        if (acked or idx is None) and self.sessions.get(handle) is sess:
            # the engine emits the abort's output on its NEXT step,
            # which an idle engine never takes — acknowledge here so
            # the client's stream always terminates.  A busy replica may
            # have stepped between the abort and this line, and its
            # output has then finished (and forgotten) the session: one
            # finish per turn, never two
            conn.send({"event": "finish", "handle": handle,
                       "reason": "abort", "retained": False})
        self._forget(sess)

    async def _handle_release(self, conn: _Conn, handle: int) -> None:
        sess = self.sessions.get(handle)
        if sess is None or sess.conn is not conn or not sess.parked:
            return
        gate = self._migrating.get(handle)
        if gate is not None:
            await gate.wait()
        idx = self.router.affinity.get(handle)
        if idx is not None:
            rep = self.replicas[idx]
            await asyncio.wrap_future(rep.call(
                rep.engine.release_session, handle))
        self._forget(sess)

    async def _on_disconnect(self, conn: _Conn) -> None:
        """A dead socket must not hold resources: abort live turns,
        release parked sessions, drop queued tickets."""
        self.queue.purge(
            lambda _c, t: isinstance(t, _Ticket) and t.conn is conn)
        for handle in list(conn.handles):
            sess = self.sessions.get(handle)
            if sess is None:
                continue
            gate = self._migrating.get(handle)
            if gate is not None:
                await gate.wait()
            idx = self.router.affinity.get(handle)
            if idx is None:                    # still queued (now purged)
                self.sessions.pop(handle, None)
                continue
            rep = self.replicas[idx]
            if sess.parked:
                await asyncio.wrap_future(rep.call(
                    rep.engine.release_session, handle))
            else:
                await asyncio.wrap_future(rep.call(rep.engine.abort, handle))
                if sess.live:
                    self.queue.done(sess.client)
            self._forget(sess)


async def serve(engines: List[ServingEngine], *, host: str = "127.0.0.1",
                port: int = 0, ready: Optional[asyncio.Event] = None,
                **kw) -> FrontendServer:
    """Convenience: start a server and return it (port 0 picks a free
    one — read ``server.port``)."""
    srv = FrontendServer(engines, host=host, port=port, **kw)
    await srv.start()
    if ready is not None:
        ready.set()
    return srv
