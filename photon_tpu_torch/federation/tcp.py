"""TCP control plane: the multi-host driver (the port of
``photon_tpu/federation/tcp.py``, without its chaos hooks and telemetry).

The server listens; node agents dial in and announce a node id (a HELLO
frame); envelopes flow as length + CRC32 prefixed pickles (``<QI`` header,
the JAX package's framing). Bulk tensors do not travel on the socket:
messages carry :class:`ParamPointer`s into the objstore plane on shared
storage. Trust model: pickles between the run's own processes on a private
network; do not expose the port. Pickles name their classes' module, so a
port node joins a port server only (the frame layout and the objstore
payloads are the JAX package's bytes).

Usage::

    # the server host (it opens no CUDA context)
    python -m photon_tpu_torch.federated --config run.yaml --tcp-listen 0.0.0.0:9777 --nodes 2

    # each node host (its trainer on cuda unless --device cpu)
    python -m photon_tpu_torch.federation.tcp --connect SERVER:9777 \\
        --node-id node0 --config run.yaml
"""

from __future__ import annotations

import argparse
import pickle
import random
import selectors
import socket
import struct
import threading
import time
import warnings
import zlib
from collections import deque
from typing import Any

from photon_tpu_torch.federation.driver import Driver
from photon_tpu_torch.federation.membership import ReconnectPolicy
from photon_tpu_torch.federation.messages import Ack, Envelope, Query

#: frame header: payload length and the payload's CRC32. A corrupt frame
#: must surface as a broken connection (the stream's framing is lost after
#: it), never as a wrong object
_FRAME = struct.Struct("<QI")
HELLO_KIND = "__hello__"
#: bound on the accept loop's HELLO read: a connected but silent peer is
#: dropped (it redials) instead of holding the accept loop
_HELLO_TIMEOUT_S = 2.0
#: bound on a node's dial; the connected socket then blocks, since a node
#: waits for its next message as long as the server's round takes
_DIAL_TIMEOUT_S = 10.0
#: TCP keepalive on a node's connected socket: after this many idle
#: seconds the kernel probes the server every interval, and after this
#: many unanswered probes the blocked read fails with ETIMEDOUT (an
#: OSError), so a server host that vanished without a FIN or RST (a crash,
#: a partition) is redialed within about 90 s
_KEEPALIVE_IDLE_S = 30
_KEEPALIVE_INTERVAL_S = 10
_KEEPALIVE_PROBES = 6
#: how long the server's shutdown waits for each node's ack
_SHUTDOWN_ACK_S = 5.0
#: how often ``wait_for_nodes`` looks at the registry
_REGISTRY_POLL_S = 0.2


class CorruptFrameError(EOFError):
    """A frame failed its CRC32 or did not unpickle. An ``EOFError``: every
    caller already tears the connection down on EOF."""


class SocketConn:
    """Length + CRC framed pickles over a stream socket, with the
    ``send``/``recv``/``close`` of a pipe, so :meth:`NodeAgent.serve` runs
    over it unchanged."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        #: absolute ``time.monotonic()`` bound on a whole ``recv`` (header
        #: and payload): a per-read timeout resets with every byte a
        #: dripping peer sends, this one does not
        self.deadline: float | None = None
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # an AF_UNIX socketpair
        self._rlock = threading.Lock()
        self._wlock = threading.Lock()

    def send(self, obj: Any) -> None:
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        with self._wlock:
            self.sock.sendall(_FRAME.pack(len(data), zlib.crc32(data)) + data)

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            if self.deadline is not None:
                remaining = self.deadline - time.monotonic()
                if remaining <= 0:
                    raise socket.timeout("recv deadline exceeded")
                self.sock.settimeout(remaining)
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise EOFError("peer closed")
            buf.extend(chunk)
        return bytes(buf)

    def recv(self) -> Any:
        with self._rlock:
            n, crc = _FRAME.unpack(self._read_exact(_FRAME.size))
            data = self._read_exact(n)
        if zlib.crc32(data) != crc:
            raise CorruptFrameError(f"frame CRC mismatch ({n} bytes)")
        try:
            return pickle.loads(data)
        except Exception as exc:
            # CRC-valid but undecodable (a peer of another version, a
            # renamed class): as untrustworthy as a corrupt frame
            raise CorruptFrameError(f"frame unpicklable ({n} bytes): {exc!r}") from exc

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _died(node_id: str, why: str = "node died") -> Ack:
    return Ack(ok=False, detail=why, node_id=node_id)


class TcpServerDriver(Driver):
    """Server side: accepts node registrations, routes envelopes."""

    def __init__(self, host: str, port: int, expected_nodes: int) -> None:
        self.expected_nodes = expected_nodes
        self._nodes: dict[str, SocketConn] = {}
        self._inflight: dict[str, list[int]] = {}
        # replies synthesized for sends to dead or unknown nodes, drained
        # by recv_any before the sockets
        self._dead_letters: deque[tuple[str, int, Ack]] = deque()
        self._hello_stats: dict[str, dict] = {}  # from each node's latest HELLO
        self._lock = threading.Lock()
        self._mid = iter(range(1 << 62))
        self._listener = socket.create_server((host, port))
        self._accepting = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               name="photon-tcp-accept", daemon=True)
        self._accept_thread.start()

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1]

    def _accept_loop(self) -> None:
        while self._accepting:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = SocketConn(sock)
            # a silent or dripping peer must not hold the accept loop nor
            # shutdown's join: socket.timeout is an OSError, so it is dropped
            conn.deadline = time.monotonic() + _HELLO_TIMEOUT_S
            try:
                hello = conn.recv()
            except (EOFError, OSError):
                conn.close()
                continue
            # validate before any keyed access: a bad HELLO drops one
            # connection, never the accept thread
            if not (isinstance(hello, dict) and hello.get("kind") == HELLO_KIND
                    and hello.get("node_id") is not None):
                conn.close()
                continue
            conn.deadline = None
            sock.settimeout(None)  # registered sockets block under the selector
            node_id = str(hello["node_id"])
            with self._lock:
                old = self._nodes.get(node_id)
                self._nodes[node_id] = conn
                # requests in flight on a replaced socket are gone (the node
                # restarted or lost that connection): fail them now, with
                # "node died" so the window re-sends the broadcast
                for mid in self._inflight.get(node_id, []):
                    self._dead_letters.append(
                        (node_id, mid, _died(node_id, "node died: reconnected mid-request")))
                self._inflight[node_id] = []
                try:
                    rc, bo = int(hello.get("reconnects", 0)), float(hello.get("backoff_s", 0.0))
                except (TypeError, ValueError):
                    rc, bo = 0, 0.0  # bad stats, a good node
                self._hello_stats[node_id] = {"reconnects": rc, "backoff_s": bo}
            if old is not None:
                old.close()

    def hello_stats(self) -> dict[str, dict]:
        with self._lock:
            return {nid: dict(s) for nid, s in self._hello_stats.items()}

    def wait_for_nodes(self, timeout: float = 300.0) -> None:
        """Block until ``expected_nodes`` have registered."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if len(self._nodes) >= self.expected_nodes:
                    return
            time.sleep(_REGISTRY_POLL_S)
        with self._lock:
            have = sorted(self._nodes)
        raise TimeoutError(f"only {len(have)}/{self.expected_nodes} nodes connected: {have}")

    # -- Driver interface ------------------------------------------------
    def node_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._nodes)

    def send(self, node_id: str, msg: Any) -> int:
        mid = next(self._mid)
        with self._lock:
            conn = self._nodes.get(node_id)
            if conn is None:
                # a node dropped from the registry whose id a caller holds
                self._dead_letters.append((node_id, mid, _died(node_id)))
                return mid
            self._inflight[node_id].append(mid)
        try:
            conn.send(Envelope(msg, mid))
        except OSError:
            pass  # surfaces as a dead-node reply in recv_any
        return mid

    def recv_any(self, timeout: float | None = None) -> tuple[str, int, Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        sel = selectors.DefaultSelector()
        try:
            while True:
                with self._lock:
                    if self._dead_letters:
                        return self._dead_letters.popleft()
                    watched = {nid: conn for nid, conn in self._nodes.items()
                               if self._inflight.get(nid)}
                if not watched:
                    raise TimeoutError("recv_any: nothing in flight")
                for nid, conn in watched.items():
                    try:
                        sel.register(conn.sock, selectors.EVENT_READ, (nid, conn))
                    except (ValueError, OSError, KeyError):
                        continue  # replaced by a re-HELLO since the snapshot
                left = None if deadline is None else max(0.0, deadline - time.monotonic())
                ready = sel.select(timeout=left)
                for key in list(sel.get_map().values()):
                    sel.unregister(key.fileobj)
                if not ready:
                    raise TimeoutError("recv_any: timeout")
                nid, conn = ready[0][0].data
                try:
                    env: Envelope = conn.recv()
                except (EOFError, OSError):
                    with self._lock:
                        if self._nodes.get(nid) is conn:
                            # dead: evict it and fail everything it owed
                            mids = self._inflight.get(nid, [])
                            self._inflight[nid] = []
                            del self._nodes[nid]
                        else:
                            # a socket a re-HELLO already replaced: its
                            # requests were failed then
                            mids = []
                        self._dead_letters.extend((nid, m, _died(nid)) for m in mids[1:])
                    conn.close()
                    if mids:
                        return nid, mids[0], _died(nid)
                    continue
                with self._lock:
                    if env.msg_id in self._inflight.get(nid, []):
                        self._inflight[nid].remove(env.msg_id)
                return nid, env.msg_id, env.msg
        finally:
            sel.close()

    def shutdown(self) -> None:
        self._accepting = False
        try:
            # shutdown wakes the accept() blocked on this socket (a close
            # alone does not on Linux); the HELLO read is deadline-bounded
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=_HELLO_TIMEOUT_S + 3)
        with self._lock:
            nodes = list(self._nodes.items())
        for _, conn in nodes:
            try:
                conn.send(Envelope(Query("shutdown"), next(self._mid)))
            except OSError:
                pass
        # wait for each node's ack before closing: an early close can reset
        # the connection before the reply lands, and the node would take a
        # clean shutdown for a lost server and redial
        for _, conn in nodes:
            try:
                conn.deadline = time.monotonic() + _SHUTDOWN_ACK_S
                conn.recv()
            except (OSError, EOFError):
                pass
            conn.close()
        with self._lock:
            self._nodes.clear()
            self._inflight.clear()
            self._hello_stats.clear()


def _keep_alive(sock: socket.socket) -> None:
    """Turn on TCP keepalive with the probe timing above."""
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPIDLE, _KEEPALIVE_IDLE_S)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPINTVL, _KEEPALIVE_INTERVAL_S)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPCNT, _KEEPALIVE_PROBES)


def run_node(server_addr: str, node_id: str, cfg_json: str, sleep=time.sleep,
             device: str | None = None) -> None:
    """The node-side supervisor: dial the server, serve the agent loop,
    and on a lost connection (or a crash that escapes the agent loop)
    redial with jittered exponential backoff and a new HELLO. Each HELLO
    carries the supervisor's cumulative ``reconnects`` and ``backoff_s``.
    ``photon.membership`` sets the backoff and the dial attempts (0 =
    retry forever); ``sleep`` is injectable; a ``shutdown`` query ends the
    loop.
    ``device`` is where the node's trainer runs (``cuda`` unless ``cpu``
    is asked for)."""
    from photon_tpu_torch.config.schema import Config
    from photon_tpu_torch.federation.node import make_node_agent

    host, _, port = server_addr.rpartition(":")
    cfg = Config.from_json(cfg_json)
    policy = ReconnectPolicy.from_config(cfg.photon.membership,
                                         rng=random.Random(zlib.crc32(node_id.encode())))
    agent = make_node_agent(cfg, node_id, device)
    attempt = 0  # consecutive failed dials; a successful dial resets it
    reconnects = 0
    backoff_total = 0.0
    while True:
        try:
            sock = socket.create_connection((host, int(port)), timeout=_DIAL_TIMEOUT_S)
        except OSError:
            attempt += 1
            if policy.exhausted(attempt):
                raise ConnectionError(
                    f"could not reach server at {server_addr} after {attempt} dials "
                    f"({backoff_total:.1f}s total backoff)") from None
            d = policy.delay(attempt - 1)
            backoff_total += d
            sleep(d)
            continue
        attempt = 0
        # the dial's timeout must not outlive the dial: an idle node (the
        # server folding, checkpointing) would time out and redial. A
        # server that went silent is found by keepalive instead
        sock.settimeout(None)
        _keep_alive(sock)
        conn = SocketConn(sock)
        clean = False
        try:
            conn.send({"kind": HELLO_KIND, "node_id": node_id, "reconnects": reconnects,
                       "backoff_s": backoff_total})
            clean = agent.serve(conn)
        except OSError:
            clean = False  # a send failed mid-reply: a lost connection
        except Exception as e:  # noqa: BLE001 — the supervisor outlives the loop
            # a crash outside per-message handling (a reply that fails to
            # pickle, say) is a torn connection: redial into the next round
            # and let the server fail what it had in flight here
            warnings.warn(f"node {node_id}: agent loop crashed ({type(e).__name__}: {e}) "
                          "— redialing into the next round", stacklevel=2)
            clean = False
        finally:
            conn.close()
        if clean:
            return
        reconnects += 1
        d = policy.delay(0)
        backoff_total += d
        sleep(d)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="photon-tpu TCP node agent (PyTorch)")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT")
    ap.add_argument("--node-id", required=True)
    ap.add_argument("--config", required=True, help="resolved config YAML")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from photon_tpu_torch.config.schema import Config

    run_node(args.connect, args.node_id, Config.from_yaml(args.config).to_json(),
             device=args.device)


if __name__ == "__main__":
    main()
