"""Minimal asyncio HTTP framework (standard library only).

The port's own copy of ``fraud_detection_tpu/service/http.py``: routing
with path parameters, a middleware chain, JSON helpers, an HTTP/1.1
keep-alive server, and an in-process TestClient.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import traceback
from typing import Any, Awaitable, Callable

log = logging.getLogger("fraud_detection_tpu_torch.http")


class Request:
    def __init__(
        self,
        method: str,
        path: str,
        headers: dict[str, str],
        body: bytes,
        path_params: dict[str, str] | None = None,
    ):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body
        self.path_params = path_params or {}
        self.state: dict[str, Any] = {}

    def json(self) -> Any:
        try:
            return json.loads(self.body or b"null")
        except json.JSONDecodeError as e:
            raise HTTPError(400, f"invalid JSON body: {e}") from e


class Response:
    def __init__(
        self,
        content: Any = None,
        status_code: int = 200,
        headers: dict[str, str] | None = None,
        media_type: str = "application/json",
    ):
        self.status_code = status_code
        self.headers = dict(headers or {})
        if isinstance(content, (bytes, str)):
            self.body = content.encode() if isinstance(content, str) else content
            self.media_type = media_type if media_type else "text/plain"
        else:
            self.body = json.dumps(content).encode()
            self.media_type = "application/json"
        self.headers.setdefault("content-type", self.media_type)

    def json(self) -> Any:
        return json.loads(self.body)

    @property
    def text(self) -> str:
        return self.body.decode()


class HTTPError(Exception):
    def __init__(self, status_code: int, detail: str):
        self.status_code = status_code
        self.detail = detail
        super().__init__(detail)


Handler = Callable[[Request], Awaitable[Response]]
Middleware = Callable[[Request, Handler], Awaitable[Response]]

_PARAM_RE = re.compile(r"\{(\w+)\}")

_STATUS_PHRASES = {
    200: "OK", 202: "Accepted", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    409: "Conflict", 422: "Unprocessable Entity", 429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}


def _compile(path: str) -> re.Pattern:
    pattern = _PARAM_RE.sub(lambda m: f"(?P<{m.group(1)}>[^/]+)", path)
    return re.compile(f"^{pattern}$")


class App:
    def __init__(self, title: str = "app"):
        self.title = title
        self.routes: list[tuple[str, re.Pattern, str, Handler]] = []
        self.middleware: list[Middleware] = []
        self.on_startup: list[Callable[[], Awaitable[None] | None]] = []
        self.on_shutdown: list[Callable[[], Awaitable[None] | None]] = []
        self._started = False

    # -- registration ------------------------------------------------------
    def route(self, method: str, path: str):
        def deco(fn: Handler) -> Handler:
            self.routes.append((method.upper(), _compile(path), path, fn))
            return fn

        return deco

    def get(self, path: str):
        return self.route("GET", path)

    def post(self, path: str):
        return self.route("POST", path)

    def add_middleware(self, mw: Middleware) -> None:
        self.middleware.append(mw)

    # -- lifecycle ---------------------------------------------------------
    async def startup(self) -> None:
        if self._started:
            return
        self._started = True
        for fn in self.on_startup:
            r = fn()
            if asyncio.iscoroutine(r):
                await r

    async def shutdown(self) -> None:
        if not self._started:
            return
        self._started = False
        for fn in self.on_shutdown:
            r = fn()
            if asyncio.iscoroutine(r):
                await r

    # -- dispatch ----------------------------------------------------------
    def route_template(self, path: str) -> str:
        """The registered pattern a path matches (for bounded-cardinality
        metric labels), or ``"<unmatched>"``."""
        for _method, pattern, template, _fn in self.routes:
            if pattern.match(path):
                return template
        return "<unmatched>"

    async def dispatch(self, request: Request) -> Response:
        async def route_handler(req: Request) -> Response:
            path_matched = False
            for method, pattern, _template, fn in self.routes:
                m = pattern.match(req.path)
                if m:
                    path_matched = True
                    if method == req.method:
                        req.path_params = m.groupdict()
                        return await fn(req)
            if path_matched:
                raise HTTPError(405, "method not allowed")
            raise HTTPError(404, "not found")

        async def error_handling(req: Request) -> Response:
            # Inside the middleware chain, so error responses still flow
            # through middleware (correlation IDs, metrics) like FastAPI's.
            try:
                return await route_handler(req)
            except HTTPError as e:
                return Response({"detail": e.detail}, status_code=e.status_code)
            except Exception:
                log.error(
                    "unhandled error on %s %s\n%s",
                    req.method, req.path, traceback.format_exc(),
                )
                return Response(
                    {"detail": "internal server error"}, status_code=500
                )

        handler: Handler = error_handling
        for mw in reversed(self.middleware):
            handler = _wrap_middleware(mw, handler)

        try:
            return await handler(request)
        except Exception:  # a middleware itself failed — last-resort 500
            log.error("middleware failure on %s %s\n%s", request.method,
                      request.path, traceback.format_exc())
            return Response({"detail": "internal server error"}, status_code=500)


def _wrap_middleware(mw: Middleware, nxt: Handler) -> Handler:
    async def wrapped(req: Request) -> Response:
        return await mw(req, nxt)

    return wrapped


# ---------------------------------------------------------------------------
# HTTP/1.1 server
# ---------------------------------------------------------------------------

_MAX_BODY = 16 * 1024 * 1024


async def _handle_connection(
    app: App, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
) -> None:
    try:
        while True:
            try:
                request_line = await reader.readline()
            except (ConnectionResetError, asyncio.IncompleteReadError):
                return
            if not request_line or request_line in (b"\r\n", b"\n"):
                return
            try:
                method, target, _version = request_line.decode().split(None, 2)
            except ValueError:
                return
            headers: dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode().partition(":")
                headers[name.strip().lower()] = value.strip()
            try:
                length = int(headers.get("content-length", 0))
            except ValueError:
                length = -1
            if length < 0 or length > _MAX_BODY:
                body400 = b'{"detail": "invalid content-length"}'
                writer.write(
                    b"HTTP/1.1 400 Bad Request\r\ncontent-type: application/json\r\n"
                    b"content-length: " + str(len(body400)).encode()
                    + b"\r\nconnection: close\r\n\r\n" + body400
                )
                await writer.drain()
                return
            body = await reader.readexactly(length) if length else b""
            path = target.split("?", 1)[0]
            response = await app.dispatch(Request(method.upper(), path, headers, body))
            phrase = _STATUS_PHRASES.get(response.status_code, "Unknown")
            head = [f"HTTP/1.1 {response.status_code} {phrase}"]
            response.headers["content-length"] = str(len(response.body))
            keep_alive = headers.get("connection", "keep-alive").lower() != "close"
            response.headers["connection"] = "keep-alive" if keep_alive else "close"
            head.extend(f"{k}: {v}" for k, v in response.headers.items())
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + response.body)
            await writer.drain()
            if not keep_alive:
                break
    except (ConnectionResetError, asyncio.IncompleteReadError, BrokenPipeError):
        pass
    finally:
        try:
            writer.close()
            await writer.wait_closed()
        except Exception:
            log.debug("connection close failed", exc_info=True)


async def start_server(
    app: App, host: str = "0.0.0.0", port: int = 8000
) -> asyncio.Server:
    """Run the app's startup hooks and start listening; the caller owns the
    returned server (close it, then ``await app.shutdown()``)."""
    await app.startup()
    server = await asyncio.start_server(
        lambda r, w: _handle_connection(app, r, w), host, port
    )
    log.info("%s listening on %s:%d", app.title, host, port)
    return server


async def serve(app: App, host: str = "0.0.0.0", port: int = 8000) -> None:
    server = await start_server(app, host, port)
    try:
        async with server:
            await server.serve_forever()
    finally:
        await app.shutdown()


def run(app: App, host: str = "0.0.0.0", port: int = 8000) -> None:
    try:
        asyncio.run(serve(app, host, port))
    except KeyboardInterrupt:
        pass


# ---------------------------------------------------------------------------
# In-process test client
# ---------------------------------------------------------------------------


class TestClient:
    """Drives the app without a socket (the reference's TestClient pattern).

    Runs a private event loop so sync test code can call async handlers;
    startup hooks run on first request, shutdown on ``close()``/context exit.
    """

    __test__ = False  # not a pytest class despite the name

    def __init__(self, app: App):
        self.app = app
        self.loop = asyncio.new_event_loop()

    def request(
        self,
        method: str,
        path: str,
        json_body: Any = None,
        headers: dict[str, str] | None = None,
    ) -> Response:
        body = b"" if json_body is None else json.dumps(json_body).encode()
        req = Request(method.upper(), path, {k.lower(): v for k, v in (headers or {}).items()}, body)

        async def go():
            await self.app.startup()
            return await self.app.dispatch(req)

        return self.loop.run_until_complete(go())

    def get(self, path: str, **kw) -> Response:
        return self.request("GET", path, **kw)

    def post(self, path: str, json: Any = None, **kw) -> Response:
        return self.request("POST", path, json_body=json, **kw)

    def close(self) -> None:
        self.loop.run_until_complete(self.app.shutdown())
        self.loop.close()

    def __enter__(self) -> "TestClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
