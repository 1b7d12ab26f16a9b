"""The port's asyncio ``HttpServer`` (``deconv_api_tpu_torch/serving/
http.py``) against the JAX package's (``deconv_api_tpu/serving/http.py``):
the raw-socket cases of ``tests/test_serving_hardening.py`` (slowloris
header, idle keep-alive, slow body, connection cap, parser fuzz, negative
``Content-Length``) sent to both servers over one echo route with 0.2 s
timeouts.  Each case's status lines must be equal."""

import asyncio
import random
import re

import pytest
import torch

from deconv_api_tpu.serving.http import HttpServer as JHttpServer
from deconv_api_tpu.serving.http import Response as JResponse
from deconv_api_tpu_torch.serving.http import HttpServer, Request, Response

TIMEOUT_S = 0.2  # every server timeout below
BOUND_S = 15.0  # every case's event loop is bounded by this


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run_http(server_cls, response_cls, scenario, **server_kw):
    """Boot a bare server with a ping and an echo route, run ``scenario``
    (port) against it, tear down."""

    async def main():
        srv = server_cls(**server_kw)

        async def ping(_req):
            return response_cls.json({"pong": True})

        srv.route("GET", "/ping")(ping)
        srv.route("POST", "/echo")(ping)
        port = await srv.start("127.0.0.1", 0)
        try:
            return await scenario(port)
        finally:
            await srv.stop()

    return asyncio.run(asyncio.wait_for(main(), BOUND_S))


def _both(scenario, **server_kw):
    """(port's result, JAX's result) of ``scenario``."""
    return (_run_http(HttpServer, Response, scenario, **server_kw),
            _run_http(JHttpServer, JResponse, scenario, **server_kw))


def _status(raw: bytes) -> bytes:
    return raw.split(b"\r\n", 1)[0]


async def _read_to_close(reader, writer, timeout=5.0) -> bytes:
    try:
        return await asyncio.wait_for(reader.read(), timeout)
    finally:
        writer.close()


def test_slowloris_header_is_reaped_without_a_response():
    async def scenario(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /ping HTTP/1.1\r\nHost: x")  # no terminator, ever
        await writer.drain()
        return await _read_to_close(reader, writer)

    assert _both(scenario, idle_timeout_s=TIMEOUT_S, body_timeout_s=TIMEOUT_S) == (b"", b"")


def test_idle_keepalive_connection_is_reaped():
    async def scenario(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /ping HTTP/1.1\r\nHost: x\r\n\r\n")
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        length = int([h for h in head.split(b"\r\n") if h.lower().startswith(b"content-length")][0].split(b":")[1])
        await reader.readexactly(length)
        return _status(head), await _read_to_close(reader, writer)  # now idle

    got, want = _both(scenario, idle_timeout_s=TIMEOUT_S)
    assert got == want == (b"HTTP/1.1 200 OK", b"")


def test_slow_body_is_a_408():
    async def scenario(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                     b"Content-Length: 1000\r\n\r\n{\"a\":")
        await writer.drain()
        return _status(await _read_to_close(reader, writer))

    got, want = _both(scenario, idle_timeout_s=5.0, body_timeout_s=TIMEOUT_S)
    assert got == want == b"HTTP/1.1 408 Request Timeout"


def test_connection_cap_is_a_503_and_held_connections_still_serve():
    async def scenario(port):
        held = [await asyncio.open_connection("127.0.0.1", port) for _ in range(2)]
        await asyncio.sleep(0.05)  # both accepted before the third arrives
        r3, w3 = await asyncio.open_connection("127.0.0.1", port)
        refused = await _read_to_close(r3, w3)
        r, w = held[0]
        w.write(b"GET /ping HTTP/1.1\r\nHost: x\r\n\r\n")
        await w.drain()
        served = await asyncio.wait_for(r.readuntil(b"\r\n\r\n"), 5.0)
        for _, w in held:
            w.close()
        return _status(refused), _status(served), b"x-request-id" in refused.lower()

    got, want = _both(scenario, max_connections=2, idle_timeout_s=5.0)
    assert got == want == (b"HTTP/1.1 503 Service Unavailable", b"HTTP/1.1 200 OK", True)


def test_parser_fuzz_answers_as_jax_and_never_kills_the_server():
    """A seeded campaign of garbage, truncated frames and hostile chunk
    framing: every connection ends in the same status line (or close) on
    both servers, no connection task dies unhandled, and each server still
    answers afterwards."""
    pieces = [
        b"POST /echo HTTP/1.1\r\n", b"GET /ping HTTP/1.1\r\n", b"\r\n\r\n",
        b"Content-Length: 10\r\n", b"Content-Length: -5\r\n",
        b"Content-Length: zz\r\n", b"Transfer-Encoding: chunked\r\n",
        b"5\r\nhello\r\n", b"0\r\n\r\n", b"-1\r\n", b"ffff\r\n",
        b"Host: x\r\n", b"\x00\xff\xfe" * 40, b"A" * 512, b": : :\r\n",
        b"HTTP/1.1 200\r\n", b"\r\n",
    ]
    rng = random.Random(0xDEC0)
    payloads = []
    for _ in range(40):
        payload = b"".join(rng.choice(pieces) for _ in range(rng.randint(1, 6)))
        payloads.append(payload[: rng.randint(1, len(payload))])

    async def scenario(port):
        unhandled: list = []
        asyncio.get_running_loop().set_exception_handler(lambda loop, ctx: unhandled.append(ctx.get("message")))

        async def one(payload: bytes) -> bytes:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            try:
                writer.write(payload)
                await writer.drain()
                writer.write_eof()
                return _status(await asyncio.wait_for(reader.read(4096), 5))
            except (ConnectionResetError, BrokenPipeError):
                return b"<reset>"
            finally:
                writer.close()

        statuses = [await one(p) for p in payloads]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /ping HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
        await writer.drain()
        return statuses, _status(await _read_to_close(reader, writer)), unhandled

    got, want = _both(scenario, idle_timeout_s=TIMEOUT_S, body_timeout_s=TIMEOUT_S)
    assert got == want
    assert got[1] == b"HTTP/1.1 200 OK" and got[2] == []
    assert len(set(got[0])) > 2  # the campaign reached several answers


def test_negative_content_length_is_a_400():
    async def scenario(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: -5\r\n\r\n")
        await writer.drain()
        return await _read_to_close(reader, writer)

    got, want = _both(scenario, idle_timeout_s=1.0, body_timeout_s=1.0)
    assert _status(got) == _status(want) == b"HTTP/1.1 400 Bad Request"
    assert b"bad content-length" in got and b"bad content-length" in want


def test_request_carries_the_deadline_and_the_request_id():
    """``x-deadline-ms`` becomes an absolute deadline, a sane
    ``x-request-id`` is echoed, an insane one replaced."""
    seen = []

    async def scenario(port):
        srv_req = []

        async def one(headers: bytes) -> bytes:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET /ping HTTP/1.1\r\nHost: x\r\nConnection: close\r\n" + headers + b"\r\n")
            await writer.drain()
            return await _read_to_close(reader, writer)

        srv_req.append(await one(b"x-request-id: abc-123\r\nx-deadline-ms: 250\r\n"))
        srv_req.append(await one(b"x-request-id: bad id!\r\n"))
        return srv_req

    async def main():
        srv = HttpServer()

        async def ping(req: Request):
            seen.append(req)
            return Response.json({"pong": True})

        srv.route("GET", "/ping")(ping)
        port = await srv.start("127.0.0.1", 0)
        try:
            return await scenario(port)
        finally:
            await srv.stop()

    raw = asyncio.run(asyncio.wait_for(main(), BOUND_S))
    assert b"x-request-id: abc-123" in raw[0]
    assert b"x-request-id: bad id!" not in raw[1] and b"x-request-id: " in raw[1]
    assert seen[0].deadline is not None and seen[1].deadline is None


def _mask_id(raw: bytes) -> bytes:
    """``raw`` with its minted request id (header and body) blanked."""
    return re.sub(rb"[0-9a-f]{6}-[0-9a-f]{8}", b"<id>", raw)


@pytest.mark.parametrize("request_bytes, status", [
    (b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: zz\r\n\r\n", 400),
    (b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 1000\r\n\r\n{", 408),
    (b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 99999999999\r\n\r\n", 413),
    (b"GET /ping HTTP/1.1\r\nHost: x\r\nX-Big: " + b"a" * (70 * 1024) + b"\r\n\r\n", 431),
    (None, 503),
], ids=["400", "408", "413", "431", "503"])
def test_protocol_reject_bodies_are_the_jax_servers(request_bytes, status):
    """The rejects no route sees answer the JAX server's bytes, apart from
    the minted id: ``{"error": <the reject's message>, "request_id": id}``
    (the connection cap's message is "too many connections")."""

    async def scenario(port):
        held = []
        if request_bytes is None:
            held = [await asyncio.open_connection("127.0.0.1", port)]
            await asyncio.sleep(0.05)
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        if request_bytes is not None:
            writer.write(request_bytes)
            await writer.drain()
        raw = await _read_to_close(reader, writer)
        for _, w in held:
            w.close()
        return raw

    got, want = _both(scenario, max_connections=1, idle_timeout_s=5.0, body_timeout_s=TIMEOUT_S)
    assert _status(got).split(b" ")[1] == str(status).encode()
    assert b'"request_id"' in got and b'"error"' in got
    assert _mask_id(got) == _mask_id(want)
