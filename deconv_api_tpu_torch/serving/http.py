"""A minimal asyncio HTTP/1.1 server (a copy of
``deconv_api_tpu/serving/http.py``).

Enough of HTTP/1.1 for the reference's wire surface (urlencoded, multipart
and JSON form POSTs, JSON responses, CORS with allow-all origins and no
credentials) plus keep-alive.  Handlers are ``async def handler(Request)
-> Response``; blocking work never runs on the event loop.  Every
response carries ``x-request-id`` (an inbound sane one is honoured, else
one is minted); ``x-deadline-ms`` becomes the request's absolute
deadline.  Connections beyond ``max_connections`` get a 503 and are
closed; a header block (or an idle keep-alive gap) slower than
``idle_timeout_s`` closes the connection, a body slower than
``body_timeout_s`` gets a 408.  While ``draining``, every response
carries ``connection: close``.  A response with a ``stream`` (the jobs'
server-sent events) is written head first, then chunk by chunk until the
stream ends, and the connection closes.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import time
from dataclasses import dataclass, field
from urllib.parse import parse_qsl, unquote, urlsplit

from deconv_api_tpu_torch import errors
from deconv_api_tpu_torch.serving import faults
from deconv_api_tpu_torch.serving.trace import deadline_from, hop_from, request_id_from
from deconv_api_tpu_torch.utils import slog

_log = slog.get_logger("deconv.http")

MAX_BODY = 64 * 1024 * 1024  # 64 MiB: base64 images are bulky
MAX_HEADER = 64 * 1024

CORS_HEADERS = {
    # Reference CORS: allow-all origins, no credentials (app/main.py:22-32).
    "access-control-allow-origin": "*",
    "access-control-allow-methods": "*",
    "access-control-allow-headers": "*",
    # without this a browser client can SEE only the safelisted headers —
    # x-request-id and x-cache would be invisible to
    # the reference's React client even though curl shows them
    "access-control-expose-headers": "*",
}

_STATUS_TEXT = {
    200: "OK", 202: "Accepted", 204: "No Content", 400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout", 411: "Length Required",
    413: "Payload Too Large", 422: "Unprocessable Entity",
    429: "Too Many Requests",
    500: "Internal Server Error", 501: "Not Implemented",
    502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]
    body: bytes
    # Stable per-request id (tracing spine): a sane inbound
    # x-request-id header is honored, otherwise the server mints one at
    # parse time.  Every response echoes it back, every access/error log
    # line and flight-recorder trace carries it — the one join key
    # across client logs, server logs, metrics exemplars and traces.
    id: str = ""
    # Absolute perf_counter deadline parsed from x-deadline-ms,
    # anchored at parse time so queue wait counts against the caller's
    # budget; None = no deadline.  The batcher reaps items whose
    # deadline lapsed at the queue-pop and pre-dispatch boundaries.
    deadline: float | None = None
    # Cross-hop trace context (fleet observability): the
    # router stamps each forward attempt with ``x-trace-hop:
    # <ordinal>:<purpose>``; parsed here (same parse-time rule as id /
    # deadline) so the backend's flight-recorder trace can annotate
    # which attempt of a retried/hedged request it served.  None for
    # direct traffic or a malformed header — never an error.
    hop: tuple[int, str] | None = None
    # Tenant identity (multi-tenant QoS): stamped by the admission wrap
    # (serving/qos.py resolves x-api-key / x-tenant) so the access-log
    # line, the flight-recorder trace and the dispatcher queue carry the
    # same identity.  Empty while QoS is off.
    tenant: str = ""
    tclass: str = ""
    # Resolved per-request model: the validated ``model=`` form field /
    # ``x-model`` header, or the server default.  Memoized by
    # DeconvService.resolve_request_model so the cache wrap, the route
    # handler and the trace agree on ONE resolution.  Empty = not yet.
    model: str = ""
    # Resolved per-request quality tier: the ``quality=`` form field, the
    # ``x-quality`` header, the QoS class's default or the server's,
    # validated against full|bf16|int8.  Memoized by
    # DeconvService.resolve_quality, as ``model`` is.  Empty = not yet.
    quality: str = ""
    # the admission Grant the QoS wrap keeps so the cache wrap can refund
    # a hit's provisional device debit
    _qos_grant: object = field(default=None, repr=False, compare=False)
    # memoized form() result: one parse per request.  None = not parsed yet.
    _form: dict[str, str] | None = field(default=None, repr=False, compare=False)
    # memoized forward-header base of the fleet router: the client headers
    # less the hop-by-hop ones, the same for every retry and hedge attempt
    # of one request.  None = not computed yet.
    _fwd_base: list | None = field(default=None, repr=False, compare=False)

    def form(self) -> dict[str, str]:
        """Parse the body as a form: urlencoded or multipart/form-data.
        Parsed once per request; repeat calls return the memoized dict
        (callers treat it as read-only)."""
        if self._form is None:
            self._form = self._parse_form_body()
        return self._form

    def _parse_form_body(self) -> dict[str, str]:
        ctype = self.headers.get("content-type", "")
        if ctype.startswith("application/x-www-form-urlencoded"):
            return {
                k: v
                for k, v in parse_qsl(
                    self.body.decode("utf-8", "replace"), keep_blank_values=True
                )
            }
        if ctype.startswith("multipart/form-data"):
            m = re.search(r'boundary="?([^";,]+)"?', ctype)
            if not m:
                raise ValueError("multipart body without boundary")
            return _parse_multipart(self.body, m.group(1).encode())
        if ctype.startswith("application/json"):
            data = json.loads(self.body.decode("utf-8"))
            if not isinstance(data, dict):
                raise ValueError("JSON form body must be an object")
            return {k: str(v) for k, v in data.items()}
        raise ValueError(f"unsupported content-type {ctype!r}")


def _parse_multipart(body: bytes, boundary: bytes) -> dict[str, str]:
    fields: dict[str, str] = {}
    delim = b"--" + boundary
    for part in body.split(delim):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        head, _, value = part.partition(b"\r\n\r\n")
        m = re.search(rb'name="([^"]*)"', head)
        if m:
            fields[m.group(1).decode()] = value.decode("utf-8", "replace")
    return fields


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    headers: dict[str, str] = field(default_factory=dict)
    # Progressive delivery (the jobs' SSE stream): an async iterator of
    # byte chunks.  When set, the serve loop writes the head (no
    # content-length, ``connection: close``) and then each chunk as the
    # iterator yields it: body-until-close framing, which is what
    # EventSource clients expect.  ``body`` is ignored.
    stream: object | None = field(default=None, repr=False, compare=False)

    @classmethod
    def json(cls, obj, status: int = 200) -> "Response":
        return cls(
            status=status,
            body=json.dumps(obj).encode(),
            headers={"content-type": "application/json"},
        )

    @classmethod
    def text(cls, s: str, status: int = 200, content_type: str = "text/plain") -> "Response":
        return cls(status=status, body=s.encode(), headers={"content-type": content_type})

    def encode(self, keep_alive: bool) -> bytes:
        headers = {
            **CORS_HEADERS,
            "content-length": str(len(self.body)),
            "connection": "keep-alive" if keep_alive else "close",
            **self.headers,
        }
        head = f"HTTP/1.1 {self.status} {_STATUS_TEXT.get(self.status, 'Unknown')}\r\n"
        head += "".join(f"{k}: {v}\r\n" for k, v in headers.items())
        return head.encode() + b"\r\n" + self.body


class HttpServer:
    """Route table + asyncio stream server.

    Abuse hardening: per-connection header/idle and body read
    timeouts bound how long a slowloris client can hold a socket (and up to
    MAX_BODY of buffer); ``max_connections`` caps concurrent sockets —
    excess connections get an immediate 503 and close.  Timeouts of 0
    disable the respective guard."""

    def __init__(
        self,
        *,
        idle_timeout_s: float = 30.0,
        body_timeout_s: float = 20.0,
        max_connections: int = 256,
    ):
        self._routes: dict[tuple[str, str], callable] = {}
        # prefix-matched routes (/v1/jobs/{id}[/...]): checked
        # after the exact table, longest prefix wins; the handler reads
        # the id out of req.path itself
        self._prefix_routes: list[tuple[str, str, callable]] = []
        self._server: asyncio.AbstractServer | None = None
        self._idle_timeout_s = idle_timeout_s
        self._body_timeout_s = body_timeout_s
        self._max_connections = max_connections
        self._nconn = 0
        # Drain-aware keep-alive: while True, every response on
        # a live connection carries `connection: close` and the serve
        # loop stops honoring keep-alive — clients learn the server is
        # going away from the LAST response they get, not from a TCP
        # reset mid-pipeline.  Set by the service at drain begin.
        self.draining = False

    def route(self, method: str, path: str):
        def register(fn):
            self._routes[(method.upper(), path)] = fn
            return fn

        return register

    def route_prefix(self, method: str, prefix: str):
        """Register a handler for every path under ``prefix`` (the per-job routes).  Exact routes win; among prefixes the
        longest match wins."""

        def register(fn):
            self._prefix_routes.append((method.upper(), prefix, fn))
            # longest prefix first, so /v1/jobs/ beats /v1/ if both exist
            self._prefix_routes.sort(key=lambda r: -len(r[1]))
            return fn

        return register

    async def start(self, host: str, port: int, *, reuse_port: bool = False) -> int:
        # reuse_port: SO_REUSEPORT lets several router processes share one
        # accept queue (the fleet router's --workers); passed only when
        # asked, so the default path stays portable
        kwargs = {"reuse_port": True} if reuse_port else {}
        self._server = await asyncio.start_server(self._handle_conn, host, port, **kwargs)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self, grace_s: float = 5.0) -> None:
        self.draining = True
        if self._server is not None:
            self._server.close()
            try:
                # Python >= 3.12.1: wait_closed() waits for ALL open client
                # connections — an idle keep-alive peer would hold shutdown
                # for up to idle_timeout_s (or forever, if active).  Bound
                # it: after the grace period the remaining connection tasks
                # are abandoned (they die with the loop) so the dispatcher
                # drain behind us still runs within a container's term
                # grace window.
                await asyncio.wait_for(self._server.wait_closed(), grace_s)
            except asyncio.TimeoutError:
                pass

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        if self._max_connections > 0 and self._nconn >= self._max_connections:
            # minted id even on a connection-cap reject: the 503 body/
            # header and the http_reject log line join on it (no request
            # was parsed, so there is no inbound id to honor)
            rid = request_id_from(None)
            slog.event(
                _log, "http_reject", level=logging.WARNING,
                status=503, reason="too_many_connections", nconn=self._nconn,
                id=rid,
            )
            try:
                resp = Response.json(
                    {"error": "too many connections", "request_id": rid}, 503
                )
                resp.headers["x-request-id"] = rid
                writer.write(resp.encode(False))
                await writer.drain()
                # Drain briefly before close: closing with unread request
                # bytes in the socket buffer sends RST, which can destroy
                # the in-flight 503 before the client reads it — the
                # back-off signal would look like a server crash.
                try:
                    await asyncio.wait_for(reader.read(65536), 0.25)
                except asyncio.TimeoutError:
                    pass
            except (ConnectionResetError, BrokenPipeError):
                pass
            finally:
                writer.close()
            return
        self._nconn += 1
        try:
            await self._serve_conn(reader, writer)
        finally:
            self._nconn -= 1

    async def _serve_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                keep_alive = (
                    req.headers.get("connection", "keep-alive") != "close"
                    and not self.draining
                )
                t0 = time.perf_counter()
                resp = await self._dispatch(req)
                # draining may have BEGUN while the handler ran: this
                # response must already tell the client to stop
                # pipelining into a dying server
                if self.draining:
                    keep_alive = False
                # EVERY response carries the request id — success, 4xx,
                # shed 503, handler-crash 500 — so a client-side log line
                # joins server logs and flight-recorder traces on one key
                resp.headers.setdefault("x-request-id", req.id)
                if resp.stream is not None:
                    # head now, chunks as they come, close at the end
                    await self._write_stream(writer, req, resp, t0)
                    break
                # 500 = handler crash -> ERROR.  503/504 are DESIGNED
                # backpressure (shedding, timeouts) — WARNING, or they
                # would flood error alerting exactly at peak load.
                lvl = (
                    logging.ERROR if resp.status == 500
                    else logging.WARNING if resp.status >= 500
                    else logging.INFO
                )
                extra = {"tenant": req.tenant} if req.tenant else {}
                slog.event(
                    _log, "http_request", level=lvl,
                    method=req.method, path=req.path, status=resp.status,
                    id=req.id,
                    ms=round((time.perf_counter() - t0) * 1e3, 1),
                    **extra,
                )
                act = faults.check("http.slow_write")
                if act is not None:
                    # chaos site: a stalled response write (saturated NIC,
                    # slow proxy) — the client-observed tail grows while
                    # the handler's own spans stay healthy
                    await asyncio.sleep((act.param or 50.0) / 1e3)
                writer.write(resp.encode(keep_alive))
                await writer.drain()
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except _ConnExpired:
            # routine idle/slowloris reaping — DEBUG, not an error signal
            slog.event(_log, "conn_expired", level=logging.DEBUG)
        except _BadRequest as e:
            # protocol-level rejections (400/408/413/431) never reach
            # _dispatch, so they get their own structured line — these are
            # exactly the abuse signals operators grep for.
            # A Request object may never have been built (the reject can
            # fire mid-header-parse), so the id is MINTED here; body,
            # header and log line carry the same one (contract:
            # every response joins on x-request-id).
            rid = request_id_from(None)
            slog.event(
                _log, "http_reject", level=logging.WARNING,
                status=e.status, reason=str(e), id=rid,
            )
            try:
                # the JAX package's body: the reject's own message, byte
                # for byte what its server answers
                resp = Response.json(
                    {"error": str(e), "request_id": rid}, e.status
                )
                resp.headers["x-request-id"] = rid
                writer.write(resp.encode(False))
                await writer.drain()
            except ConnectionResetError:
                pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionResetError:
                pass

    async def _write_stream(
        self,
        writer: asyncio.StreamWriter,
        req: Request,
        resp: Response,
        t0: float,
    ) -> None:
        """Write a streaming response: head without content-length, then
        every chunk the iterator yields.  The access log line lands when
        the stream ENDS (its ms is the stream's whole lifetime).  A
        client that disconnects mid-stream surfaces as ConnectionReset
        in the caller's handler; the generator is always closed so its
        finally blocks (subscription cleanup) run."""
        headers = {
            **CORS_HEADERS,
            "connection": "close",
            "cache-control": "no-cache",
            **resp.headers,
        }
        head = (
            f"HTTP/1.1 {resp.status} "
            f"{_STATUS_TEXT.get(resp.status, 'Unknown')}\r\n"
        )
        head += "".join(f"{k}: {v}\r\n" for k, v in headers.items())
        try:
            writer.write(head.encode() + b"\r\n")
            await writer.drain()
            async for chunk in resp.stream:
                writer.write(chunk)
                await writer.drain()
        finally:
            aclose = getattr(resp.stream, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:  # noqa: BLE001 — cleanup must not mask
                    pass
            slog.event(
                _log, "http_request", level=logging.INFO,
                method=req.method, path=req.path, status=resp.status,
                id=req.id, stream=True,
                ms=round((time.perf_counter() - t0) * 1e3, 1),
            )

    async def _read_request(self, reader: asyncio.StreamReader) -> Request | None:
        try:
            # One clock bounds both idle keep-alive waits and slow-header
            # (slowloris) sends: a client gets idle_timeout_s to deliver a
            # complete header block, then the connection is reaped.
            head = await self._timed(
                reader.readuntil(b"\r\n\r\n"), self._idle_timeout_s
            )
        except asyncio.TimeoutError:
            raise _ConnExpired from None
        except asyncio.IncompleteReadError as e:
            if not e.partial:
                return None  # clean close between keep-alive requests
            raise
        except asyncio.LimitOverrunError:
            raise _BadRequest(431, "headers too large") from None
        if len(head) > MAX_HEADER:
            raise _BadRequest(431, "headers too large")
        # Single-pass parse (fast path): walk the raw bytes with
        # one find() per boundary instead of whole-head decode + split +
        # per-line partition.  Every proxied request pays this parse on
        # the router hop, so its allocations are hop-budget dollars.
        # Semantics are unchanged: keys stripped+lowercased, values
        # stripped, colon-less non-empty lines become empty-valued keys.
        end = len(head) - 4  # drop the trailing \r\n\r\n
        eol = head.find(b"\r\n", 0, end)
        if eol < 0:
            eol = end
        reqline = head[:eol].decode("latin-1")
        try:
            method, target, _version = reqline.split(" ", 2)
        except ValueError:
            raise _BadRequest(400, f"malformed request line {reqline!r}") from None
        headers: dict[str, str] = {}
        pos = eol + 2
        while pos < end:
            nxt = head.find(b"\r\n", pos, end)
            if nxt < 0:
                nxt = end
            if nxt > pos:
                colon = head.find(b":", pos, nxt)
                if colon < 0:
                    headers[head[pos:nxt].strip().lower().decode("latin-1")] = ""
                else:
                    headers[
                        head[pos:colon].strip().lower().decode("latin-1")
                    ] = head[colon + 1 : nxt].strip().decode("latin-1")
            pos = nxt + 2
        body = b""
        if "content-length" in headers:
            try:
                n = int(headers["content-length"])
            except ValueError:
                raise _BadRequest(400, "bad content-length") from None
            if n < 0:
                # readexactly(-5) would raise an uncaught ValueError and
                # kill the connection task (same hazard as the chunked
                # path's negative chunk size below; r3 fuzz-review finding)
                raise _BadRequest(400, "bad content-length")
            if n > MAX_BODY:
                raise _BadRequest(413, "body too large")
            try:
                body = await self._timed(reader.readexactly(n), self._body_timeout_s)
            except asyncio.TimeoutError:
                raise _BadRequest(408, "body read timed out") from None
        elif headers.get("transfer-encoding", "").lower() == "chunked":
            try:
                body = await self._timed(
                    self._read_chunked(reader), self._body_timeout_s
                )
            except asyncio.TimeoutError:
                raise _BadRequest(408, "body read timed out") from None
        parts = urlsplit(target)
        query = {k: v for k, v in parse_qsl(parts.query, keep_blank_values=True)}
        return Request(
            method.upper(), unquote(parts.path), query, headers, body,
            request_id_from(headers.get("x-request-id")),
            deadline_from(headers.get("x-deadline-ms")),
            hop_from(headers.get("x-trace-hop")),
        )

    async def _read_chunked(self, reader: asyncio.StreamReader) -> bytes:
        chunks = []
        total = 0
        while True:
            try:
                # readline raises (LimitOverrun wrapped in ValueError) when
                # a "chunk-size line" exceeds the StreamReader limit — a
                # malformed or hostile request, not a server error
                size_line = (await reader.readline()).strip()
            except (asyncio.LimitOverrunError, ValueError):
                raise _BadRequest(400, "bad chunk framing") from None
            try:
                n = int(size_line.split(b";")[0], 16)
            except ValueError:
                raise _BadRequest(400, "bad chunk size") from None
            if n < 0:
                # int(b"-1", 16) parses; readexactly(-1) would raise an
                # uncaught ValueError and kill the connection task
                raise _BadRequest(400, "bad chunk size")
            if n == 0:
                await reader.readline()
                return b"".join(chunks)
            total += n
            if total > MAX_BODY:
                raise _BadRequest(413, "body too large")
            chunks.append(await reader.readexactly(n))
            await reader.readexactly(2)  # trailing CRLF

    async def _dispatch(self, req: Request) -> Response:
        if req.method == "OPTIONS":  # CORS preflight
            return Response(204)
        handler = self._routes.get((req.method, req.path))
        if handler is None:
            for method, prefix, fn in self._prefix_routes:
                if method == req.method and req.path.startswith(prefix):
                    handler = fn
                    break
        if handler is None:
            if any(p == req.path for (_, p) in self._routes) or any(
                req.path.startswith(prefix)
                for (_, prefix, _fn) in self._prefix_routes
            ):
                return Response.json({"error": "method not allowed"}, 405)
            return Response.json({"error": f"no route for {req.path}"}, 404)
        try:
            return await handler(req)
        except Exception as e:  # noqa: BLE001 — last-resort 500, never a dropped conn
            _log.exception("handler crash on %s", req.path)
            slog.event(
                _log, "handler_crash", level=logging.ERROR,
                path=req.path, id=req.id, error=f"{type(e).__name__}: {e}",
            )
            # one payload shape for every error body (errors.to_payload):
            # the base DeconvError carries internal_error/500
            return Response.json(
                errors.to_payload(
                    errors.DeconvError(f"{type(e).__name__}: {e}"), req.id
                ),
                500,
            )


    @staticmethod
    async def _timed(coro, timeout_s: float):
        """await with a timeout; 0 disables (tests, trusted meshes)."""
        if timeout_s <= 0:
            return await coro
        return await asyncio.wait_for(coro, timeout_s)


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _ConnExpired(Exception):
    """Idle/slow-header connection reaped; closed without a response (a
    slowloris peer never reads it, an idle keep-alive peer expects none)."""
