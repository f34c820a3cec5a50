"""Transport layer: how tasks, operands, results and heartbeats move.

Everything wire-shaped that used to be scattered across ``pool.py`` /
``worker.py`` / ``backend.py`` — pipes, the shared result queue, the
shared-memory operand blocks — lives behind one seam:

* :class:`Transport` (master side) creates one :class:`Channel` per worker
  (``connect``), publishes a batch's encoded operands once
  (``publish`` → :class:`OperandHandle`), and funnels every worker's
  results/pongs into a single ``results`` queue.
* :func:`make_worker_endpoint` (worker side) rebuilds the matching
  endpoint from the picklable spawn argument: ``recv`` for task messages,
  ``send`` for ready/done/pong, ``get_operands`` to resolve a task's
  operand reference.

Two implementations:

* :class:`LocalTransport` — the original single-machine plumbing,
  bit-identical: duplex pipes per worker, one multiprocessing queue for
  results, operands in shared memory (workers attach read-only, see
  :func:`_attach_shm`).
* :class:`SocketTransport` — TCP.  The master binds one listener per
  configured "host" address (two localhost entries exercise the multi-host
  assignment on one machine); each spawned worker dials its host:port back
  and identifies itself with its ready handshake.  Messages are
  **length-prefixed frames** (8-byte big-endian length + pickle payload);
  a batch's operand blocks are shipped at most once per (worker, batch) —
  the frame rides the same ordered stream directly before the first task
  that references it.  A peer disconnect or truncated frame marks the
  channel dead, which the pool's liveness sweep turns into lost-shard
  events instead of a hang.

The wire is numpy and bytes: operands cross processes as host arrays.  A
worker that cannot start (no card, no kernel) answers its startup
handshake with a ``("failed", wid, message)`` frame instead of ``ready``;
the channel keeps the message in :attr:`error` so the pool can raise it.
"""
from __future__ import annotations

import pickle
import queue as queue_mod
import socket
import struct
import threading
from collections import OrderedDict
from multiprocessing import shared_memory

import numpy as np

from ..names import unknown_name
from ..obs import NULL_REGISTRY
from .config import global_config

__all__ = [
    "Transport", "LocalTransport", "SocketTransport", "TransportClosed",
    "OperandHandle", "TRANSPORT_NAMES", "make_transport",
    "make_worker_endpoint", "send_frame", "recv_frame", "send_msg",
    "recv_msg",
]

_HEADER = struct.Struct("!Q")          # frame := len(payload) ++ payload
_RECV_CHUNK = 1 << 20

TRANSPORT_NAMES = ("local", "socket")


class TransportClosed(ConnectionError):
    """The peer went away mid-conversation (EOF, truncated frame, reset)."""


# --------------------------------------------------------------- framing
def send_frame(sock: socket.socket, payload: bytes) -> None:
    """Write one length-prefixed frame (empty payloads are legal)."""
    try:
        sock.sendall(_HEADER.pack(len(payload)))
        if payload:
            sock.sendall(payload)
    except OSError as e:
        raise TransportClosed(f"send failed: {e}") from None


def _recv_exact(sock: socket.socket, n: int, what: str) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(min(n - len(buf), _RECV_CHUNK))
        except OSError as e:
            raise TransportClosed(f"recv failed mid-{what}: {e}") from None
        if not chunk:
            raise TransportClosed(
                f"peer closed mid-{what} ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket, max_bytes: int | None = None) -> bytes:
    """Read one frame; raises :class:`TransportClosed` on EOF/truncation."""
    try:
        first = sock.recv(_HEADER.size)
    except OSError as e:
        raise TransportClosed(f"recv failed: {e}") from None
    if not first:
        raise TransportClosed("peer closed")      # clean EOF between frames
    head = first if len(first) == _HEADER.size else \
        first + _recv_exact(sock, _HEADER.size - len(first), "header")
    (n,) = _HEADER.unpack(head)
    limit = global_config.frame_max_bytes if max_bytes is None else max_bytes
    if n > limit:
        raise TransportClosed(f"frame length {n} exceeds cap {limit} — "
                              "corrupt or hostile length prefix")
    return _recv_exact(sock, n, "frame") if n else b""


def send_msg(sock: socket.socket, msg) -> int:
    """Frame + send one pickled message; returns bytes put on the wire."""
    payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    send_frame(sock, payload)
    return _HEADER.size + len(payload)


def recv_msg(sock: socket.socket):
    payload = recv_frame(sock)
    try:
        return pickle.loads(payload)
    except Exception as e:                        # noqa: BLE001 — any decode
        raise TransportClosed(f"undecodable frame: {e}") from None


# ------------------------------------------------------------- shared shm
def _attach_shm(name: str) -> shared_memory.SharedMemory:
    """Attach an existing shared-memory block without tracker registration.

    On CPython < 3.13 every attach registers the segment with the process's
    resource tracker, which then tries to unlink it at exit — double-free
    noise (and, worst case, destruction of a segment the master still owns:
    bpo-38119).  The master created the segment and owns its lifecycle; the
    worker only reads it, so the attach is untracked.  The *attachment*
    itself is still a resource: callers must close it on every exit path —
    :meth:`LocalWorkerEndpoint.release_operands` tracks live attachments so
    a worker dying mid-task cannot leak them until interpreter exit.
    """
    from multiprocessing import resource_tracker
    orig = resource_tracker.register

    def _skip_shm(rname, rtype):
        if rtype != "shared_memory":
            orig(rname, rtype)

    resource_tracker.register = _skip_shm
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


def _to_shm(arr: np.ndarray) -> tuple[shared_memory.SharedMemory, tuple]:
    """Copy ``arr`` into a fresh shared-memory block; returns (block, meta)."""
    arr = np.ascontiguousarray(arr)
    shm = shared_memory.SharedMemory(create=True, size=arr.nbytes)
    np.ndarray(arr.shape, dtype=arr.dtype, buffer=shm.buf)[:] = arr
    return shm, (shm.name, arr.shape, arr.dtype.str)


# --------------------------------------------------------------- operands
class OperandHandle:
    """One published batch of encoded operands.

    ``ref`` is the picklable reference a task message carries (shm metadata
    on the local transport, a cache token on the socket transport);
    ``payload`` holds the arrays a socket channel ships on first use.
    ``release`` is idempotent and frees the master-side resources.
    """

    def __init__(self, token, ref, release_fn, payload=None):
        self.token = token
        self.ref = ref
        self.payload = payload
        self._release_fn = release_fn
        self.released = False

    def release(self) -> None:
        if self.released:
            return
        self.released = True
        self._release_fn()


# ----------------------------------------------------- transport metrics
class _TransportMetrics:
    """Pre-resolved transport instruments (one attribute hop per event).

    Resolving ``registry.counter(name)`` per send would cost a dict lookup
    on the hot path; binding once at pool construction keeps the per-send
    cost at one ``inc`` call (a no-op instrument when metrics are off).
    """

    __slots__ = ("msgs", "frames", "bytes", "operands", "cache_hits",
                 "deaths", "live")

    def __init__(self, registry):
        self.msgs = registry.counter("transport.msgs_sent")
        self.frames = registry.counter("transport.frames_sent")
        self.bytes = registry.counter("transport.bytes_sent")
        self.operands = registry.counter("transport.operands_published")
        self.cache_hits = registry.counter("transport.operand_cache_hits")
        self.deaths = registry.counter("transport.channel_deaths")
        self.live = registry.gauge("transport.live_operands")


_NULL_TM = _TransportMetrics(NULL_REGISTRY)


# ------------------------------------------------------- master channels
class LocalChannel:
    """Master end of one worker's duplex pipe."""

    kind = "local"

    def __init__(self, conn, tm: _TransportMetrics = _NULL_TM):
        self.conn = conn
        self.dead = False
        self.error: str | None = None     # the worker's startup failure
        self._ready = False
        self._closing = False
        self._tm = tm

    def _mark_dead(self) -> None:
        # a death after we initiated shutdown is a clean exit, not a loss
        if not self.dead:
            self.dead = True
            if not self._closing:
                self._tm.deaths.inc()

    def send(self, msg, operands: OperandHandle | None = None) -> bool:
        # operands live in shared memory; the ref inside ``msg`` is enough
        if msg and msg[0] == "shutdown":
            self._closing = True
        try:
            self.conn.send(msg)
            self._tm.msgs.inc()
            return True
        except (BrokenPipeError, OSError):
            self._mark_dead()
            return False

    def poll_ready(self, timeout: float = 0.0) -> bool:
        if self._ready:
            return True
        try:
            if self.conn.poll(timeout):
                msg = self.conn.recv()
                if msg[0] == "ready":
                    self._ready = True
                elif msg[0] == "failed":
                    self.error = str(msg[2])
                    self._mark_dead()
        except (EOFError, OSError):
            self._mark_dead()
        return self._ready

    def close(self) -> None:
        self._closing = True
        try:
            self.conn.close()
        except OSError:
            pass


class SocketChannel:
    """Master end of one worker's TCP connection.

    The socket is attached by the transport's accept loop once the worker
    dials back and identifies itself; until then ``send`` blocks (bounded
    by the connect timeout).  A send/recv failure marks the channel dead —
    the pool's liveness sweep reports its in-flight shards lost.
    """

    kind = "socket"

    def __init__(self, wid: int, connect_timeout: float,
                 tm: _TransportMetrics = _NULL_TM):
        self.wid = int(wid)
        self.sock: socket.socket | None = None
        self.addr: tuple | None = None
        self.dead = False
        self.error: str | None = None     # the worker's startup failure
        self._connect_timeout = float(connect_timeout)
        self._ready = threading.Event()
        self._attached = threading.Event()
        self._shipped: set = set()        # operand tokens already on the wire
        self._lock = threading.Lock()     # one writer at a time on the sock
        self._closing = False
        self._tm = tm

    def attach(self, sock: socket.socket, addr) -> None:
        self.sock = sock
        self.addr = addr
        self._attached.set()
        self._ready.set()                 # identification IS the handshake

    def _mark_dead(self) -> None:
        # a death after we initiated shutdown is a clean exit, not a loss
        if not self.dead:
            self.dead = True
            if not self._closing:
                self._tm.deaths.inc()

    def send(self, msg, operands: OperandHandle | None = None) -> bool:
        if self.dead:
            return False
        if msg and msg[0] == "shutdown":
            self._closing = True
        if not self._attached.wait(timeout=self._connect_timeout):
            self._mark_dead()
            return False
        tm = self._tm
        try:
            with self._lock:
                if operands is not None:
                    if operands.token not in self._shipped:
                        E_A, E_B = operands.payload
                        n = send_msg(self.sock,
                                     ("operands", operands.token, E_A, E_B))
                        self._shipped.add(operands.token)
                        tm.frames.inc()
                        tm.bytes.inc(n)
                    else:                 # operands already on this wire
                        tm.cache_hits.inc()
                n = send_msg(self.sock, msg)
            tm.msgs.inc()
            tm.frames.inc()
            tm.bytes.inc(n)
            return True
        except (TransportClosed, OSError):
            self._mark_dead()
            return False

    def fail(self, error: str) -> None:
        """The worker dialled back to report a startup failure."""
        self.error = str(error)
        self._mark_dead()
        self._ready.set()

    def poll_ready(self, timeout: float = 0.0) -> bool:
        return self._ready.wait(timeout=timeout if timeout > 0 else 0) \
            and self.error is None

    def close(self) -> None:
        self._closing = True
        self.dead = True
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass


# ------------------------------------------------------------- transports
class Transport:
    """Master-side transport base (see module docstring for the contract)."""

    kind = "abstract"

    def __init__(self):
        self._published: dict = {}        # token -> live OperandHandle
        self._tm = _NULL_TM               # rebind via bind_metrics()

    def bind_metrics(self, registry) -> None:
        """Resolve transport instruments against ``registry`` (idempotent).

        Channels created *after* the bind carry the instruments; the pool
        binds before it spawns anyone, so in practice that is all of them.
        """
        if registry is not None and getattr(registry, "enabled", False):
            self._tm = _TransportMetrics(registry)

    # one unified result stream: ("done", ...) / ("pong", ...) messages;
    # ``get(timeout=...)`` raises ``queue.Empty`` — both backends comply
    results: object

    def connect(self, wid: int):
        """New worker channel; returns ``(channel, endpoint_spawn_arg)``."""
        raise NotImplementedError

    def publish(self, E_A: np.ndarray, E_B: np.ndarray) -> OperandHandle:
        """Make one batch's operands addressable by task messages."""
        raise NotImplementedError

    @property
    def live_operands(self) -> int:
        """Published-but-unreleased batches (tests assert 0 at teardown)."""
        return len(self._published)

    def _track(self, handle: OperandHandle) -> OperandHandle:
        self._published[handle.token] = handle
        self._tm.operands.inc()
        self._tm.live.set(len(self._published))
        return handle

    def _untrack(self, token) -> None:
        self._published.pop(token, None)
        self._tm.live.set(len(self._published))

    def close(self) -> None:
        for handle in list(self._published.values()):
            handle.release()              # safety net: no shm outlives us


class LocalTransport(Transport):
    """Pipes + shared result queue + shared-memory operands (one machine)."""

    kind = "local"

    def __init__(self, ctx, **_):
        super().__init__()
        self._ctx = ctx
        self.results = ctx.Queue()

    def connect(self, wid: int):
        parent_conn, child_conn = self._ctx.Pipe()
        return (LocalChannel(parent_conn, self._tm),
                ("local", child_conn, self.results))

    def publish(self, E_A, E_B) -> OperandHandle:
        shm_a, a_meta = _to_shm(E_A)
        shm_b, b_meta = _to_shm(E_B)
        token = shm_a.name

        def _release():
            for shm in (shm_a, shm_b):
                shm.close()
                shm.unlink()
            self._untrack(token)

        return self._track(OperandHandle(token, (a_meta, b_meta), _release))

    def close(self) -> None:
        super().close()
        self.results.cancel_join_thread()
        self.results.close()


class SocketTransport(Transport):
    """TCP transport: one listener per host address, workers dial back.

    ``hosts`` is the list of listener addresses (default from
    :data:`~repro_torch.cluster.config.global_config` — two localhost
    entries, the in-repo stand-in for a pool spanning machines).  Worker
    ``wid`` is assigned host ``wid % len(hosts)``; its spawn argument
    carries that host:port, so on a real deployment the spawn argument is
    the only thing a remote launcher needs to ship.
    """

    kind = "socket"

    def __init__(self, ctx=None, hosts=None, port: int | None = None,
                 connect_timeout: float | None = None, **_):
        super().__init__()
        cfg = global_config
        self.hosts = tuple(hosts) if hosts else cfg.socket_hosts
        if not self.hosts:
            raise ValueError("socket transport needs at least one host")
        self.connect_timeout = cfg.connect_timeout \
            if connect_timeout is None else float(connect_timeout)
        self.results: queue_mod.Queue = queue_mod.Queue()
        self._pending: dict[int, SocketChannel] = {}
        self._channels: list[SocketChannel] = []
        self._listeners: list[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False
        self._next_token = 0
        bind_port = cfg.socket_port if port is None else int(port)
        for host in self.hosts:
            srv = socket.create_server((host, bind_port))
            self._listeners.append(srv)
            threading.Thread(target=self._accept_loop, args=(srv,),
                             daemon=True,
                             name=f"sac-accept-{srv.getsockname()[1]}"
                             ).start()

    @property
    def addresses(self) -> list[tuple[str, int]]:
        """The bound ``(host, port)`` of every listener, in host order."""
        return [s.getsockname()[:2] for s in self._listeners]

    def connect(self, wid: int):
        host, port = self.addresses[int(wid) % len(self._listeners)]
        chan = SocketChannel(wid, self.connect_timeout, self._tm)
        with self._lock:
            self._pending[int(wid)] = chan
            self._channels.append(chan)
        return chan, ("socket", host, port, int(wid))

    def publish(self, E_A, E_B) -> OperandHandle:
        token = self._next_token
        self._next_token += 1
        payload = (np.ascontiguousarray(E_A), np.ascontiguousarray(E_B))
        return self._track(OperandHandle(
            token, token, lambda: self._untrack(token), payload=payload))

    # ------------------------------------------------------- accept/route
    def _accept_loop(self, srv: socket.socket) -> None:
        while not self._closed:
            try:
                sock, addr = srv.accept()
            except OSError:
                return                    # listener closed: shutting down
            threading.Thread(target=self._handshake, args=(sock, addr),
                             daemon=True).start()

    def _handshake(self, sock: socket.socket, addr) -> None:
        """Identify a dialing worker by its first frame and wire it up."""
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            msg = recv_msg(sock)
        except (TransportClosed, OSError):
            sock.close()
            return
        failed = isinstance(msg, tuple) and len(msg) == 3 \
            and msg[0] == "failed"
        if not (isinstance(msg, tuple) and len(msg) == 2
                and msg[0] == "ready") and not failed:
            sock.close()                  # stranger on the port
            return
        with self._lock:
            chan = self._pending.pop(int(msg[1]), None)
        if chan is None or failed:
            sock.close()
            if chan is not None:
                chan.fail(msg[2])
            return
        chan.attach(sock, addr)
        threading.Thread(target=self._reader, args=(chan,), daemon=True,
                         name=f"sac-reader-{chan.wid}").start()

    def _reader(self, chan: SocketChannel) -> None:
        """Route one worker's results/pongs into the shared stream."""
        while True:
            try:
                msg = recv_msg(chan.sock)
            except TransportClosed:
                chan._mark_dead()         # EOF / truncation → lost shards
                return
            self.results.put(msg)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        super().close()
        for srv in self._listeners:
            try:
                srv.close()
            except OSError:
                pass
        with self._lock:
            chans = list(self._channels)
        for chan in chans:
            chan.close()


def make_transport(spec, *, ctx=None, hosts=None, metrics=None) -> Transport:
    """``"local"`` | ``"socket"`` | a ready :class:`Transport` instance."""
    if isinstance(spec, Transport):
        if metrics is not None:
            spec.bind_metrics(metrics)
        return spec
    name = global_config.transport if spec is None else str(spec)
    if name == "local":
        if ctx is None:
            raise ValueError("local transport needs a multiprocessing ctx")
        tr = LocalTransport(ctx)
    elif name == "socket":
        tr = SocketTransport(hosts=hosts)
    else:
        raise unknown_name("transport", name, TRANSPORT_NAMES)
    if metrics is not None:
        tr.bind_metrics(metrics)
    return tr


# -------------------------------------------------------- worker endpoints
class LocalWorkerEndpoint:
    """Worker side of :class:`LocalTransport` (pipe + queue + shm attach)."""

    kind = "local"

    def __init__(self, conn, result_q):
        self._conn = conn
        self._result_q = result_q
        self._attached: list[shared_memory.SharedMemory] = []

    def recv(self):
        try:
            return self._conn.recv()
        except (EOFError, OSError):
            raise TransportClosed("master went away") from None

    def send(self, msg) -> None:
        if msg[0] in ("ready", "failed"):  # handshake rides the task pipe;
            try:                           # results ride the shared queue
                self._conn.send(msg)
            except (BrokenPipeError, OSError):
                raise TransportClosed("master went away") from None
        else:
            self._result_q.put(msg)

    def get_operands(self, ref):
        (a_name, a_shape, a_dtype), (b_name, b_shape, b_dtype) = ref
        shm_a = _attach_shm(a_name)
        self._attached.append(shm_a)
        shm_b = _attach_shm(b_name)
        self._attached.append(shm_b)
        E_A = np.ndarray(a_shape, dtype=np.dtype(a_dtype), buffer=shm_a.buf)
        E_B = np.ndarray(b_shape, dtype=np.dtype(b_dtype), buffer=shm_b.buf)
        return E_A, E_B

    def release_operands(self) -> None:
        """Close every live attachment (idempotent, every-exit-path safe)."""
        while self._attached:
            shm = self._attached.pop()
            try:
                shm.close()
            except OSError:
                pass

    def close(self) -> None:
        self.release_operands()
        try:
            self._conn.close()
        except OSError:
            pass


class SocketWorkerEndpoint:
    """Worker side of :class:`SocketTransport` (dial back, cache operands)."""

    kind = "socket"

    def __init__(self, host: str, port: int, wid: int):
        cfg = global_config
        try:
            self._sock = socket.create_connection(
                (host, port), timeout=cfg.connect_timeout)
        except OSError as e:
            raise TransportClosed(f"dial {host}:{port} failed: {e}") \
                from None
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._cache: OrderedDict = OrderedDict()
        self._cache_batches = max(1, cfg.operand_cache_batches)

    def recv(self):
        while True:
            msg = recv_msg(self._sock)
            if msg[0] == "operands":      # broadcast frame: cache and keep
                _, token, E_A, E_B = msg  # reading for the task behind it
                self._cache[token] = (E_A, E_B)
                while len(self._cache) > self._cache_batches:
                    self._cache.popitem(last=False)
                continue
            return msg

    def send(self, msg) -> None:
        send_msg(self._sock, msg)

    def get_operands(self, ref):
        if ref not in self._cache:        # ordered stream: can only happen
            raise TransportClosed(        # past the cache horizon
                f"operands {ref!r} not in cache (horizon "
                f"{self._cache_batches} batches)")
        return self._cache[ref]

    def release_operands(self) -> None:
        """No-op: the cache evicts by age (re-dispatch may revisit)."""

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def make_worker_endpoint(arg):
    """Rebuild the worker-side endpoint from its picklable spawn argument."""
    kind = arg[0]
    if kind == "local":
        return LocalWorkerEndpoint(arg[1], arg[2])
    if kind == "socket":
        return SocketWorkerEndpoint(arg[1], arg[2], arg[3])
    raise unknown_name("endpoint kind", kind, TRANSPORT_NAMES)
