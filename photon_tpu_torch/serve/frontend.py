"""Stdlib-HTTP serving frontend: ``/generate`` and ``/healthz``.

The port of ``photon_tpu/serve/frontend.py`` (``/metrics``, ``/statusz``
and ``/debug/profile`` are not ported). A ``ThreadingHTTPServer`` whose
handler threads block on the batcher's per-request output queues; the
scheduler's single thread does all engine work.

``POST /generate`` accepts JSON::

    {"tokens": [1, 2, 3],          # prompt token ids
     "max_new_tokens": 32,         # capped by photon.serve.max_new_tokens
     "temperature": 0.0,           # 0 = greedy
     "seed": 0,                    # sampling stream seed
     "eos_id": 256,                # per-request EOS (default: photon.serve)
     "stream": false}

A ``"text"`` prompt is tokenized by the server's tokenizer (``--tokenizer
byte-fallback``; a server without one answers 400), and the reply then
carries the completion's ``"text"`` too. Blocking responses return one JSON object;
``"stream": true`` switches to chunked transfer with one JSON line per
token, then a final stats line. A full queue answers 429 with a
``Retry-After`` hint; a draining server answers 503, as does one whose
engine was left without params by a failed swap (its ``/healthz`` then
answers 503 with ``"status": "failed"`` until a later swap succeeds).
"""

from __future__ import annotations

import json
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from photon_tpu_torch.ops import ragged_paged_attention as rpa
from photon_tpu_torch.serve.scheduler import (
    ContinuousBatcher,
    DrainingError,
    EngineFailedError,
    QueueFullError,
)


class ServeFrontend:
    """HTTP face over a running :class:`ContinuousBatcher`."""

    def __init__(self, batcher: ContinuousBatcher, *, host: str = "127.0.0.1",
                 port: int = 0, max_new_tokens_cap: int = 64,
                 request_timeout_s: float = 300.0, tokenizer=None) -> None:
        self.batcher = batcher
        self.tokenizer = tokenizer
        self.host = host
        self.port = port
        self.max_new_tokens_cap = max_new_tokens_cap
        self.request_timeout_s = request_timeout_s
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        #: graceful-drain flag (SIGTERM): /healthz says "draining", new
        #: /generate gets 503, in-flight handler threads keep streaming
        self.draining = False
        #: the hot-swap watcher, when one runs (its counters on /healthz)
        self.watcher = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> int:
        fe = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # chunked transfer needs 1.1

            def log_message(self, *args) -> None:
                pass

            def _json(self, code: int, obj: dict, extra_headers: dict | None = None) -> None:
                body = (json.dumps(obj) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _chunk(self, data: bytes) -> None:
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

            def _discard_body(self) -> None:
                # keep-alive: an early reject must still consume the body
                try:
                    n = int(self.headers.get("Content-Length", 0) or 0)
                except ValueError:
                    n = 0
                if n > 0:
                    self.rfile.read(n)

            def do_GET(self) -> None:  # noqa: N802 — http.server API
                if self.path.rstrip("/") != "/healthz":
                    self._discard_body()
                    self._json(404, {"error": f"no route {self.path!r}"})
                    return
                eng = fe.batcher.engine
                payload = {
                    "status": "failed" if eng.failed else (
                        "draining" if fe.draining else "ok"),
                    "round": eng.loaded_round,
                    "model": eng.mc.name,
                    "device": str(eng.device),
                    "attn_impl": eng.attn_impl,
                    "slots_free": eng.n_slots - eng.n_active,
                    "blocks_free": eng.free_blocks,
                    "queue_depth": fe.batcher.queue_depth,
                    "completed": fe.batcher.completed,
                    "rejected": fe.batcher.rejected,
                    "swaps": fe.batcher.swaps,
                    "load": fe.batcher.load_report(),
                    "stats": fe.batcher.stats(),
                    # CUDA kernel launches since start (0 on the CPU path)
                    "kernel_launches": {"ragged_paged_attention": rpa.launches},
                }
                if (prefix := eng.prefix_stats()) is not None:
                    payload["prefix_cache"] = prefix
                if (spec := fe.batcher.spec_stats()) is not None:
                    payload["speculative"] = spec
                if fe.watcher is not None:
                    payload["hotswap"] = fe.watcher.stats()
                if eng.failed:
                    payload["error"] = eng.failed
                self._json(503 if eng.failed else 200, payload)

            def do_POST(self) -> None:  # noqa: N802 — http.server API
                if self.path.rstrip("/") != "/generate":
                    self._discard_body()
                    self._json(404, {"error": f"no route {self.path!r}"})
                    return
                if fe.draining:
                    self._discard_body()
                    self._json(503, {"error": "server draining"}, {"Retry-After": "5"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad JSON body: {e}"})
                    return
                try:
                    prompt = fe._resolve_prompt(body)
                    max_new = min(int(body.get("max_new_tokens", fe.max_new_tokens_cap)),
                                  fe.max_new_tokens_cap)
                    eos = body.get("eos_id")
                    req = fe.batcher.submit(
                        prompt, max_new,
                        temperature=float(body.get("temperature", 0.0)),
                        seed=int(body.get("seed", 0)),
                        eos_id=None if eos is None else int(eos),
                    )
                except QueueFullError as e:
                    self._json(429, {"error": str(e)}, {"Retry-After": "1"})
                    return
                except (DrainingError, EngineFailedError) as e:
                    self._json(503, {"error": str(e)}, {"Retry-After": "5"})
                    return
                except (TypeError, ValueError, RuntimeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                if body.get("stream"):
                    self._stream(req)
                else:
                    self._blocking(req)

            def _blocking(self, req) -> None:
                try:
                    tokens = req.result(timeout=fe.request_timeout_s)
                except Exception as e:  # noqa: BLE001 — surface, don't hang
                    self._json(500, {"error": str(e)})
                    return
                self._json(200, fe._result_payload(req, tokens))

            def _stream(self, req) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonl")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for tok in req.stream(timeout=fe.request_timeout_s):
                        self._chunk((json.dumps({"token": int(tok)}) + "\n").encode())
                    final = fe._result_payload(req, req.generated)
                except Exception as e:  # noqa: BLE001 — close the stream honestly
                    final = {"error": str(e)}
                final["done"] = True
                self._chunk((json.dumps(final) + "\n").encode())
                self.wfile.write(b"0\r\n\r\n")

        class _Server(ThreadingHTTPServer):
            # daemon handler threads, tracked so a graceful drain can join
            # them (bounded) instead of exiting mid-reply
            def process_request(self, request, client_address):
                t = threading.Thread(target=self.process_request_thread,
                                     args=(request, client_address),
                                     name="photon-serve-handler", daemon=True)
                self._handler_threads.add(t)
                t.start()

            def join_handlers(self, timeout_s: float) -> bool:
                deadline = time.monotonic() + timeout_s
                for t in list(self._handler_threads):
                    t.join(timeout=max(0.0, deadline - time.monotonic()))
                return all(not t.is_alive() for t in self._handler_threads)

        self._httpd = _Server((self.host, self.port), Handler)
        self._httpd._handler_threads = weakref.WeakSet()
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="photon-serve-http", daemon=True)
        self._thread.start()
        return self.port

    def mark_draining(self) -> None:
        """/healthz answers ``draining`` and new /generate gets 503; pair
        with :meth:`ContinuousBatcher.drain`, then :meth:`close`."""
        self.draining = True

    def close(self, handler_join_s: float = 0.0) -> None:
        """Stop the HTTP server; ``handler_join_s > 0`` also waits, bounded,
        for in-flight handlers to finish writing their replies."""
        if self._httpd is not None:
            self._httpd.shutdown()
            if handler_join_s > 0:
                self._httpd.join_handlers(handler_join_s)
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- request plumbing -------------------------------------------------
    def _resolve_prompt(self, body: dict) -> list[int]:
        if body.get("tokens") is not None:
            toks = body["tokens"]
            vocab = self.batcher.engine.mc.vocab_size
            if not isinstance(toks, list) or not all(
                isinstance(t, int) and 0 <= t < vocab for t in toks
            ):
                raise ValueError(f"'tokens' must be a list of ints in [0, {vocab})")
            return toks
        if body.get("text") is not None:
            if self.tokenizer is None:
                raise ValueError("'text' prompts need a server-side tokenizer; send 'tokens'")
            if not isinstance(body["text"], str):
                raise ValueError("'text' must be a string")
            return list(self.tokenizer.encode(body["text"]))
        raise ValueError("need 'tokens' or 'text'")

    def _result_payload(self, req, tokens: list[int]) -> dict:
        out = {
            "tokens": [int(t) for t in tokens],
            "n_prompt": len(req.prompt),
            "n_generated": len(req.generated),
            "ttft_s": round(req.ttft_s, 6),
            "total_s": round(max(0.0, req.t_done - req.t_submit), 6),
        }
        if self.tokenizer is not None:
            out["text"] = self.tokenizer.decode(tokens)
        return out
