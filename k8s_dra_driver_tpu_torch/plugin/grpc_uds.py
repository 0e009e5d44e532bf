"""gRPC over HTTP/2 on unix sockets, written by hand: the kubelet's two
sockets without ``grpcio``.

The reference serves its registration and DRA node services with two
``grpc.server``s (``kubeletplugin._serve_uds``). The machine with the
card has neither ``grpcio`` nor ``protobuf``, so the port speaks the same
bytes with the standard library (``socket``, ``threading``, ``struct``),
:mod:`.hpack` and the wire codec (``kube/protos/wire.py``):

- **HTTP/2 cleartext with prior knowledge** (RFC 9113): the client
  preface, SETTINGS both ways (the peer's HEADER_TABLE_SIZE,
  INITIAL_WINDOW_SIZE and MAX_FRAME_SIZE are honoured), PING answered
  with an ACK echoing its payload, PRIORITY and unknown frame types
  ignored, PUSH_PROMISE from a client a connection error, RST_STREAM
  ending one stream and not the connection, HEADERS with PADDED and
  PRIORITY and CONTINUATION frames after them.
- **Flow control both ways**: WINDOW_UPDATE on the connection and the
  stream as DATA is read; DATA is sent only inside the peer's
  connection and stream windows, waiting for its WINDOW_UPDATE.
- **gRPC** (PROTOCOL-HTTP2.md): ``:path`` is ``/service/method``; a
  message is a compressed flag byte, a 4-byte big-endian length and the
  bytes, over as many DATA frames as it takes; a reply is HEADERS
  (``:status 200``, ``content-type: application/grpc``), DATA, and
  trailers ``grpc-status: 0`` with END_STREAM; an error is a
  trailers-only reply whose ``grpc-message`` is percent-encoded. The
  codes and details are those ``grpcio``'s server gives: UNIMPLEMENTED
  "Method not found!" for an unknown method, UNKNOWN "Exception calling
  application: ..." for a handler that raises. ``grpc-timeout`` is not
  read: the client keeps its own deadline.
- **Concurrency**: one reader thread per connection, handlers in a pool
  of 8 workers (the reference's ``ThreadPoolExecutor(max_workers=8)``),
  one write lock per connection so that frames of different streams
  never interleave inside a frame.

:class:`Server` serves one method table on one socket; :class:`Channel`
is the client (the kubelet's side) over the same framing; and
:class:`SocketTransport` is the ``KubeletPlugin`` transport that serves
the DRA node methods on the plugin socket and the registration methods
on the registrar socket, as the reference's ``KubeletPlugin.start``
splits them.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import logging
import os
import socket
import struct
import threading
import time
from typing import Optional

from . import hpack
from .grpc_services import CALL_TIMEOUT_S, REGISTRATION_SERVICE_NAME

logger = logging.getLogger(__name__)

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# Frame types (RFC 9113 section 6).
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, \
    GOAWAY, WINDOW_UPDATE, CONTINUATION = range(10)
# Flags.
END_STREAM = ACK = 0x1
END_HEADERS = 0x4
PADDED = 0x8
PRIORITY_FLAG = 0x20
# SETTINGS parameters.
SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_ENABLE_PUSH = 0x2
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5
# Error codes.
NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR = 0, 1, 2, 3
STREAM_CLOSED, FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL = 5, 6, 7, 8
COMPRESSION_ERROR = 9

DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384
MAX_WINDOW = (1 << 31) - 1

# gRPC status codes (grpc/include/grpc/status.h).
OK, CANCELLED, UNKNOWN, DEADLINE_EXCEEDED = 0, 1, 2, 4
RESOURCE_EXHAUSTED, UNIMPLEMENTED, INTERNAL, UNAVAILABLE = 8, 12, 13, 14
# grpcio's default cap on a received message.
MAX_MESSAGE = 4 << 20

# sockaddr_un.sun_path holds 108 bytes with the terminating NUL.
UNIX_PATH_MAX = 107
WORKERS = 8
GRACE_S = 2.0
CONNECT_TIMEOUT_S = 10.0
# How often the accept loop looks for stop: shutdown() of a listening
# socket does not wake accept() on every kernel.
ACCEPT_POLL_S = 0.1

_FRAME_HEADER = struct.Struct(">IBI")   # length << 8 | type, flags, id
_GRPC_PREFIX = struct.Struct(">BI")


class RpcError(Exception):
    """A call that ended with a non-zero ``grpc-status``: ``code()`` and
    ``details()`` as ``grpc.RpcError`` gives them (the code as its
    number)."""

    def __init__(self, code: int, details: str):
        super().__init__(f"gRPC status {code}: {details}")
        self._code = code
        self._details = details

    def code(self) -> int:
        return self._code

    def details(self) -> str:
        return self._details


class _ConnectionError(Exception):
    """A connection error: GOAWAY with ``code``, then close."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class _StreamGone(Exception):
    """The stream was reset, or the connection closed, mid-send."""


def check_socket_path(path: str) -> None:
    n = len(os.fsencode(path))
    if n > UNIX_PATH_MAX:
        raise ValueError(f"unix socket path of {n} bytes is over the "
                         f"AF_UNIX limit of {UNIX_PATH_MAX}: {path}")


def percent_encode(message: str) -> str:
    """gRPC's ``grpc-message`` encoding: UTF-8, with every byte outside
    0x20-0x7E and ``%`` itself as ``%XX``."""
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}"
                   for b in message.encode("utf-8"))


def percent_decode(value: str) -> str:
    raw = value.encode("latin-1")
    out = bytearray()
    i = 0
    while i < len(raw):
        digits = raw[i + 1:i + 3]
        if raw[i] == 0x25 and len(digits) == 2 and \
                all(c in b"0123456789abcdefABCDEF" for c in digits):
            out.append(int(digits, 16))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return out.decode("utf-8", "replace")


def grpc_frame(message: bytes) -> bytes:
    return _GRPC_PREFIX.pack(0, len(message)) + message


class _Stream:
    def __init__(self, stream_id: int, send_window: int):
        self.id = stream_id
        self.send_window = send_window
        self.headers: list = []
        self.trailers: list = []
        self.data = bytearray()
        self.reset: Optional[int] = None   # the RST_STREAM error code
        self.done = threading.Event()      # client: the reply is whole


class _Connection:
    """The framing both ends share: frame I/O, SETTINGS, PING, windows,
    header blocks and flow-controlled DATA. Subclasses say what a whole
    header block, a DATA frame and a stream's end mean."""

    client = False

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.write_lock = threading.Lock()
        self.cond = threading.Condition()
        self.encoder = hpack.Encoder()
        self.decoder = hpack.Decoder()
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.peer_initial_window = DEFAULT_WINDOW
        self.send_window = DEFAULT_WINDOW
        self.streams: dict = {}
        self.closed = False
        self._block: Optional[tuple] = None   # (stream id, flags, bytes)
        self._buf = bytearray()

    # -- I/O ----------------------------------------------------------------

    def _read(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(max(65536, n - len(self._buf)))
            if not chunk:
                raise EOFError
            self._buf += chunk
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def _frame(self, ftype: int, flags: int, stream_id: int,
               payload=b"") -> bytes:
        return _FRAME_HEADER.pack(len(payload) << 8 | ftype, flags,
                                  stream_id) + bytes(payload)

    def write_frame(self, ftype: int, flags: int, stream_id: int,
                    payload=b"") -> None:
        with self.write_lock:
            self.sock.sendall(self._frame(ftype, flags, stream_id, payload))

    def _answer(self, frames: bytes) -> None:
        """The reader's own writes (ACKs, WINDOW_UPDATE). A peer that
        has closed its end may still have sent frames not yet read, so a
        failed write does not stop the reading."""
        with self.write_lock, contextlib.suppress(OSError):
            self.sock.sendall(frames)

    def _header_frames(self, stream_id: int, fields, end_stream: bool):
        """The HEADERS frame and any CONTINUATION frames of one block;
        call with the write lock held (the encoder's state follows the
        order blocks go out)."""
        block = self.encoder.encode(fields)
        step = self.peer_max_frame
        chunks = [block[i:i + step] for i in range(0, len(block), step)] \
            or [b""]
        out = bytearray()
        for i, chunk in enumerate(chunks):
            flags = END_HEADERS if i == len(chunks) - 1 else 0
            if i == 0:
                out += self._frame(HEADERS, flags | (END_STREAM if end_stream
                                                     else 0),
                                   stream_id, chunk)
            else:
                out += self._frame(CONTINUATION, flags, stream_id, chunk)
        return bytes(out)

    def send_headers(self, stream_id: int, fields,
                     end_stream: bool = False) -> None:
        with self.write_lock:
            self.sock.sendall(self._header_frames(stream_id, fields,
                                                  end_stream))

    def send_data(self, stream: _Stream, payload: bytes, end_stream: bool,
                  deadline: Optional[float] = None) -> None:
        """``payload`` as DATA frames, each inside the peer's connection
        and stream windows and its MAX_FRAME_SIZE; waits for the peer's
        WINDOW_UPDATE when a window is spent, until ``deadline``
        (monotonic seconds), past which it raises ``TimeoutError``."""
        view = memoryview(payload)
        off = 0
        while True:
            with self.cond:
                while True:
                    if self.closed or stream.reset is not None:
                        raise _StreamGone
                    n = max(0, min(len(payload) - off, self.peer_max_frame,
                                   self.send_window, stream.send_window))
                    if n or off == len(payload):
                        break
                    left = None if deadline is None \
                        else deadline - time.monotonic()
                    if left is not None and left <= 0:
                        raise TimeoutError
                    self.cond.wait(left)
                self.send_window -= n
                stream.send_window -= n
            last = off + n == len(payload)
            self.write_frame(DATA, END_STREAM if last and end_stream else 0,
                             stream.id, view[off:off + n])
            off += n
            if last:
                return

    def goaway(self, last_stream_id: int, code: int = NO_ERROR,
               debug: bytes = b"") -> None:
        with contextlib.suppress(OSError):
            self.write_frame(GOAWAY, 0, 0,
                             struct.pack(">II", last_stream_id, code) + debug)

    def close(self) -> None:
        with self.cond:
            self.closed = True
            self.cond.notify_all()
        with contextlib.suppress(OSError):
            self.sock.shutdown(socket.SHUT_RDWR)
        self.sock.close()

    # -- the reader ---------------------------------------------------------

    def run(self) -> None:
        """The reader thread: frames until EOF, a connection error or
        ``close``."""
        try:
            if not self.client and self._read(len(PREFACE)) != PREFACE:
                raise _ConnectionError(PROTOCOL_ERROR, "bad client preface")
            while True:
                head = self._read(9)
                length = int.from_bytes(head[:3], "big")
                ftype, flags = head[3], head[4]
                stream_id = int.from_bytes(head[5:], "big") & MAX_WINDOW
                if length > DEFAULT_MAX_FRAME:
                    raise _ConnectionError(FRAME_SIZE_ERROR,
                                           f"frame of {length} bytes")
                self._on_frame(ftype, flags, stream_id, self._read(length))
        except _ConnectionError as e:
            logger.debug("HTTP/2 connection error %d: %s", e.code, e)
            self.goaway(self.last_stream_id(), e.code, str(e).encode())
        except (EOFError, OSError):
            pass
        except Exception:
            logger.exception("HTTP/2 connection failed")
            self.goaway(self.last_stream_id(), INTERNAL_ERROR)
        finally:
            self.close()
            self._on_closed()

    def _on_frame(self, ftype, flags, stream_id, payload) -> None:
        if self._block is not None and ftype != CONTINUATION:
            raise _ConnectionError(PROTOCOL_ERROR, "expected CONTINUATION")
        if ftype == DATA:
            if stream_id == 0:
                raise _ConnectionError(PROTOCOL_ERROR, "DATA on stream 0")
            body = self._unpad(flags, payload)
            self._update_windows(stream_id, len(payload),
                                 stream=not flags & END_STREAM)
            self._on_data(stream_id, body, bool(flags & END_STREAM))
        elif ftype == HEADERS:
            if stream_id == 0:
                raise _ConnectionError(PROTOCOL_ERROR, "HEADERS on stream 0")
            fragment = self._unpad(flags, payload)
            if flags & PRIORITY_FLAG:
                fragment = fragment[5:]
            self._block = (stream_id, flags, bytearray(fragment))
            if flags & END_HEADERS:
                self._end_block()
        elif ftype == CONTINUATION:
            if self._block is None or self._block[0] != stream_id:
                raise _ConnectionError(PROTOCOL_ERROR,
                                       "CONTINUATION out of place")
            self._block[2].extend(payload)
            if flags & END_HEADERS:
                self._end_block()
        elif ftype == SETTINGS:
            self._on_settings(flags, stream_id, payload)
        elif ftype == PING:
            if len(payload) != 8:
                raise _ConnectionError(FRAME_SIZE_ERROR, "PING of "
                                       f"{len(payload)} bytes")
            if not flags & ACK:
                self._answer(self._frame(PING, ACK, 0, payload))
        elif ftype == WINDOW_UPDATE:
            self._on_window_update(stream_id, payload)
        elif ftype == RST_STREAM:
            if len(payload) != 4:
                raise _ConnectionError(FRAME_SIZE_ERROR, "RST_STREAM size")
            self._on_reset(stream_id, int.from_bytes(payload, "big"))
        elif ftype == GOAWAY:
            self._on_goaway(int.from_bytes(payload[:4], "big") & MAX_WINDOW)
        elif ftype == PUSH_PROMISE:
            raise _ConnectionError(PROTOCOL_ERROR, "PUSH_PROMISE received")
        # PRIORITY and unknown frame types are ignored (RFC 9113 5.5).

    @staticmethod
    def _unpad(flags: int, payload: bytes) -> bytes:
        if not flags & PADDED:
            return payload
        if not payload or payload[0] >= len(payload):
            raise _ConnectionError(PROTOCOL_ERROR, "padding too long")
        return payload[1:len(payload) - payload[0]]

    def _end_block(self) -> None:
        stream_id, flags, block = self._block
        self._block = None
        try:
            fields = self.decoder.decode(bytes(block))
        except hpack.HpackError as e:
            raise _ConnectionError(COMPRESSION_ERROR, str(e)) from None
        self._on_headers(stream_id, fields, bool(flags & END_STREAM))

    def _on_settings(self, flags, stream_id, payload) -> None:
        if stream_id:
            raise _ConnectionError(PROTOCOL_ERROR, "SETTINGS on a stream")
        if flags & ACK:
            return
        if len(payload) % 6:
            raise _ConnectionError(FRAME_SIZE_ERROR, "SETTINGS size")
        table_size = None
        with self.cond:
            for i in range(0, len(payload), 6):
                key, value = struct.unpack(">HI", payload[i:i + 6])
                if key == SETTINGS_HEADER_TABLE_SIZE:
                    table_size = value
                elif key == SETTINGS_INITIAL_WINDOW_SIZE:
                    if value > MAX_WINDOW:
                        raise _ConnectionError(FLOW_CONTROL_ERROR,
                                               "INITIAL_WINDOW_SIZE")
                    delta = value - self.peer_initial_window
                    self.peer_initial_window = value
                    for stream in self.streams.values():
                        stream.send_window += delta
                elif key == SETTINGS_MAX_FRAME_SIZE:
                    if not DEFAULT_MAX_FRAME <= value < 1 << 24:
                        raise _ConnectionError(PROTOCOL_ERROR,
                                               "MAX_FRAME_SIZE")
                    self.peer_max_frame = value
            self.cond.notify_all()
        # The encoder changes under the write lock, in order with the
        # header blocks it encodes.
        with self.write_lock, contextlib.suppress(OSError):
            if table_size is not None:
                self.encoder.set_peer_table_size(table_size)
            self.sock.sendall(self._frame(SETTINGS, ACK, 0))

    def _on_window_update(self, stream_id, payload) -> None:
        if len(payload) != 4:
            raise _ConnectionError(FRAME_SIZE_ERROR, "WINDOW_UPDATE size")
        increment = int.from_bytes(payload, "big") & MAX_WINDOW
        with self.cond:
            if stream_id == 0:
                if not increment or \
                        self.send_window + increment > MAX_WINDOW:
                    raise _ConnectionError(FLOW_CONTROL_ERROR,
                                           "connection window")
                self.send_window += increment
            else:
                stream = self.streams.get(stream_id)
                if stream is not None:
                    stream.send_window += increment
            self.cond.notify_all()

    def _update_windows(self, stream_id: int, n: int, stream: bool) -> None:
        """Give back what a DATA frame took from our windows."""
        if not n:
            return
        out = self._frame(WINDOW_UPDATE, 0, 0, n.to_bytes(4, "big"))
        if stream and stream_id in self.streams:
            out += self._frame(WINDOW_UPDATE, 0, stream_id,
                               n.to_bytes(4, "big"))
        self._answer(out)

    # -- what subclasses define ---------------------------------------------

    def last_stream_id(self) -> int:
        return 0

    def _on_headers(self, stream_id, fields, end_stream) -> None:
        raise NotImplementedError

    def _on_data(self, stream_id, body, end_stream) -> None:
        raise NotImplementedError

    def _on_reset(self, stream_id, code) -> None:
        with self.cond:
            stream = self.streams.pop(stream_id, None)
            if stream is not None:
                stream.reset = code
                stream.done.set()
            self.cond.notify_all()

    def _on_goaway(self, last_stream_id) -> None:
        pass

    def _on_closed(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class _ServerConnection(_Connection):
    def __init__(self, sock, server: "Server"):
        super().__init__(sock)
        self.server = server
        self.highest = 0            # the last stream id taken
        self.goaway_sent: Optional[int] = None

    def last_stream_id(self) -> int:
        return self.highest

    def _on_headers(self, stream_id, fields, end_stream) -> None:
        with self.cond:
            stream = self.streams.get(stream_id)
            if stream is None:
                if stream_id % 2 == 0 or stream_id <= self.highest:
                    # A closed stream's trailers after our reset, or an
                    # id a client may not use.
                    if stream_id % 2 == 0:
                        raise _ConnectionError(PROTOCOL_ERROR,
                                               f"stream id {stream_id}")
                    return
                self.highest = stream_id
                if self.goaway_sent is not None:
                    refused = True
                else:
                    refused = False
                    stream = self.streams[stream_id] = _Stream(
                        stream_id, self.peer_initial_window)
                    stream.headers = fields
            else:
                refused = False
                stream.trailers = fields
        if refused:
            self.write_frame(RST_STREAM, 0, stream_id,
                             REFUSED_STREAM.to_bytes(4, "big"))
        elif end_stream:
            self._dispatch(stream)

    def _on_data(self, stream_id, body, end_stream) -> None:
        stream = self.streams.get(stream_id)
        if stream is None:
            return                  # reset by the client: drop
        stream.data += body
        if len(stream.data) > MAX_MESSAGE + 5:
            self._finish_error(stream, RESOURCE_EXHAUSTED,
                               f"Received message larger than max "
                               f"({len(stream.data) - 5} vs. {MAX_MESSAGE})")
            return
        if end_stream:
            self._dispatch(stream)

    def _dispatch(self, stream: _Stream) -> None:
        try:
            self.server.pool.submit(self._serve, stream)
        except RuntimeError:        # the pool is shut down: stopping
            self._on_reset(stream.id, REFUSED_STREAM)

    def _serve(self, stream: _Stream) -> None:
        try:
            code, details, reply = self.server.handle(stream)
            if stream.reset is not None:
                return
            if code != OK:
                self._finish_error(stream, code, details)
                return
            self.send_headers(stream.id, (
                (":status", "200"), ("content-type", "application/grpc")))
            self.send_data(stream, grpc_frame(reply), end_stream=False)
            self.send_headers(stream.id, (("grpc-status", "0"),),
                              end_stream=True)
        except (_StreamGone, OSError):
            pass                    # reset by the client, or disconnected
        except Exception:
            # No one reads a pool task's result: report it here.
            logger.exception("serving stream %d failed", stream.id)
        finally:
            self._forget(stream)

    def _finish_error(self, stream: _Stream, code: int, details: str) -> None:
        """A trailers-only reply: the status in the one HEADERS frame."""
        fields = [(":status", "200"), ("content-type", "application/grpc"),
                  ("grpc-status", str(code))]
        if details:
            fields.append(("grpc-message", percent_encode(details)))
        with contextlib.suppress(OSError):
            if stream.reset is None:
                self.send_headers(stream.id, fields, end_stream=True)
        self._forget(stream)

    def _forget(self, stream: _Stream) -> None:
        with self.cond:
            self.streams.pop(stream.id, None)
            self.cond.notify_all()
        with self.server.cond:
            self.server.cond.notify_all()

    def _on_reset(self, stream_id, code) -> None:
        super()._on_reset(stream_id, code)
        with self.server.cond:
            self.server.cond.notify_all()

    def _on_closed(self) -> None:
        self.server._forget_connection(self)


class Server:
    """One method table served on one unix socket: ``methods`` maps a
    gRPC full method name to (request class, handler, reply class), as
    ``kubeletplugin.method_table`` gives it; a handler takes
    ``(request, context)`` with ``context`` None, as
    ``kubeletplugin.LocalTransport`` calls it."""

    def __init__(self, path: str, methods: dict):
        self.path = path
        self.methods = methods
        self.pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self.cond = threading.Condition()
        self.connections: list = []
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._readers: list = []
        self._stopping = False

    @property
    def bound(self) -> bool:
        return self._sock is not None

    def start(self) -> "Server":
        """Create the socket's directory, unlink a stale socket file,
        bind, and accept connections in a thread of their own."""
        check_socket_path(self.path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if os.path.exists(self.path):
            os.unlink(self.path)   # stale socket from a previous run
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.bind(self.path)
            sock.listen(64)
        except OSError:
            sock.close()
            raise
        sock.settimeout(ACCEPT_POLL_S)
        self.pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=WORKERS, thread_name_prefix="grpc-uds")
        self._sock = sock
        self._accept_thread = threading.Thread(
            target=self._accept, name=f"grpc-uds-accept {self.path}",
            daemon=True)
        self._accept_thread.start()
        return self

    def _accept(self) -> None:
        while not self._stopping:
            try:
                sock, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.setblocking(True)
            conn = _ServerConnection(sock, self)
            with self.cond:
                if self._stopping:
                    sock.close()
                    return
                self.connections.append(conn)
            try:
                conn.write_frame(SETTINGS, 0, 0)   # defaults: no parameter
            except OSError:
                conn.close()
                continue
            reader = threading.Thread(target=conn.run, daemon=True,
                                      name=f"grpc-uds-conn {self.path}")
            self._readers.append(reader)
            reader.start()

    def _forget_connection(self, conn) -> None:
        with self.cond:
            if conn in self.connections:
                self.connections.remove(conn)
            self.cond.notify_all()

    def handle(self, stream: _Stream) -> tuple:
        """(code, details, reply bytes) of one whole request."""
        fields = dict(stream.headers)
        entry = self.methods.get(fields.get(":path", ""))
        if entry is None:
            return UNIMPLEMENTED, "Method not found!", b""
        body = bytes(stream.data)
        if len(body) < 5:
            return INTERNAL, "Missing request message", b""
        compressed, length = _GRPC_PREFIX.unpack_from(body)
        if len(body) != 5 + length:
            return INTERNAL, "Not exactly one request message", b""
        if compressed:
            encoding = fields.get("grpc-encoding", "identity")
            return (UNIMPLEMENTED, f"Compressed message with grpc-encoding "
                    f"{encoding!r}: only identity is supported", b"")
        request_cls, handler, _ = entry
        try:
            request = request_cls.FromString(body[5:])
        except Exception:
            return INTERNAL, "Exception deserializing request!", b""
        try:
            reply = handler(request, None)
        except Exception as e:
            logger.exception("Exception calling application: %s", e)
            return UNKNOWN, f"Exception calling application: {e}", b""
        try:
            return OK, "", reply.SerializeToString()
        except Exception:
            return INTERNAL, "Exception serializing response!", b""

    def stop(self, grace: float = GRACE_S) -> None:
        """Stop accepting, send GOAWAY with the last stream id on every
        connection, let in-flight calls finish for up to ``grace``
        seconds (0 when a start failed halfway), close, and unlink the
        socket file."""
        with self.cond:
            self._stopping = True
            conns = list(self.connections)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        if self._sock is not None:
            self._sock.close()
        for conn in conns:
            with conn.cond:
                conn.goaway_sent = conn.highest
            conn.goaway(conn.highest)
        deadline = time.monotonic() + grace
        with self.cond:
            while any(c.streams for c in self.connections):
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self.cond.wait(left)
            conns = list(self.connections)
        for conn in conns:
            conn.close()
        deadline = time.monotonic() + 1.0
        for reader in self._readers:     # daemons: a late one is left
            reader.join(max(0.0, deadline - time.monotonic()))
        if self.pool is not None:
            self.pool.shutdown(wait=False, cancel_futures=True)
        self._sock = None
        with contextlib.suppress(OSError):
            os.unlink(self.path)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class _ClientConnection(_Connection):
    client = True

    def __init__(self, sock):
        super().__init__(sock)
        self.next_id = 1
        self.goaway_last: Optional[int] = None

    def _on_headers(self, stream_id, fields, end_stream) -> None:
        stream = self.streams.get(stream_id)
        if stream is None:
            return
        if stream.headers:
            stream.trailers = fields
        else:
            stream.headers = fields
        if end_stream:
            self._end(stream)

    def _on_data(self, stream_id, body, end_stream) -> None:
        stream = self.streams.get(stream_id)
        if stream is None:
            return
        stream.data += body
        if end_stream:
            self._end(stream)

    def _end(self, stream: _Stream) -> None:
        with self.cond:
            self.streams.pop(stream.id, None)
        stream.done.set()

    def _on_goaway(self, last_stream_id) -> None:
        with self.cond:
            self.goaway_last = last_stream_id
            for sid in [s for s in self.streams if s > last_stream_id]:
                stream = self.streams.pop(sid)
                stream.reset = REFUSED_STREAM
                stream.done.set()
            self.cond.notify_all()

    def _on_closed(self) -> None:
        with self.cond:
            streams = list(self.streams.values())
            self.streams.clear()
        for stream in streams:
            stream.done.set()


class Channel:
    """A client connection on a unix socket, as a kubelet holds one:
    ``call(method_path, request_bytes, timeout) -> reply_bytes``. Calls
    from several threads share the connection as separate streams. A
    non-zero ``grpc-status`` raises :class:`RpcError`."""

    def __init__(self, path: str):
        self.path = path
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(CONNECT_TIMEOUT_S)
        try:
            sock.connect(path)
        except OSError:
            sock.close()
            raise
        sock.settimeout(None)
        self._conn = _ClientConnection(sock)
        with self._conn.write_lock:
            sock.sendall(PREFACE + self._conn._frame(
                SETTINGS, 0, 0, struct.pack(">HI", SETTINGS_ENABLE_PUSH, 0)))
        self._reader = threading.Thread(target=self._conn.run, daemon=True,
                                        name=f"grpc-uds-client {path}")
        self._reader.start()

    @property
    def usable(self) -> bool:
        conn = self._conn
        return not conn.closed and conn.goaway_last is None

    def call(self, method_path: str, request: bytes,
             timeout: Optional[float] = CALL_TIMEOUT_S) -> bytes:
        conn = self._conn
        fields = [(":method", "POST"), (":scheme", "http"),
                  (":path", method_path), (":authority", "localhost"),
                  ("content-type", "application/grpc"), ("te", "trailers")]
        if timeout is not None:
            fields.append(("grpc-timeout", f"{max(1, int(timeout * 1e3))}m"))
        with conn.write_lock:
            with conn.cond:
                if conn.closed or conn.goaway_last is not None:
                    raise RpcError(UNAVAILABLE, "connection closed")
                stream = _Stream(conn.next_id, conn.peer_initial_window)
                conn.next_id += 2
                conn.streams[stream.id] = stream
            try:
                conn.sock.sendall(conn._header_frames(stream.id, fields,
                                                      end_stream=False))
            except OSError as e:
                raise RpcError(UNAVAILABLE, f"send failed: {e}") from None
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            conn.send_data(stream, grpc_frame(request), end_stream=True,
                           deadline=deadline)
        except (_StreamGone, OSError):
            pass                    # the stream's end is read below
        except TimeoutError:
            deadline = time.monotonic()
        if not stream.done.wait(None if deadline is None else
                                max(0.0, deadline - time.monotonic())):
            with contextlib.suppress(OSError):
                conn.write_frame(RST_STREAM, 0, stream.id,
                                 CANCEL.to_bytes(4, "big"))
            conn._on_reset(stream.id, CANCEL)
            raise RpcError(DEADLINE_EXCEEDED, "Deadline Exceeded")
        return self._reply(stream)

    @staticmethod
    def _reply(stream: _Stream) -> bytes:
        if stream.reset is not None:
            code = UNAVAILABLE if stream.reset == REFUSED_STREAM \
                else CANCELLED
            raise RpcError(code, f"stream reset with HTTP/2 error "
                           f"{stream.reset}")
        headers = dict(stream.headers)
        trailers = dict(stream.trailers) if stream.trailers else headers
        if "grpc-status" not in trailers:
            raise RpcError(UNAVAILABLE if not headers else UNKNOWN,
                           "the stream ended without grpc-status (HTTP "
                           f"status {headers.get(':status')})")
        code = int(trailers["grpc-status"])
        if code != OK:
            raise RpcError(code, percent_decode(
                trailers.get("grpc-message", "")))
        body = bytes(stream.data)
        if len(body) < 5:
            raise RpcError(INTERNAL, "no reply message")
        compressed, length = _GRPC_PREFIX.unpack_from(body)
        if compressed or len(body) != 5 + length:
            raise RpcError(INTERNAL, "not one uncompressed reply message")
        return body[5:]

    def close(self) -> None:
        conn = self._conn
        if not conn.closed:
            conn.goaway(0)
            conn.close()
        self._reader.join(timeout=5)

    def __enter__(self) -> "Channel":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# The KubeletPlugin transport
# ---------------------------------------------------------------------------


class SocketTransport:
    """The plugin's services on its two unix sockets: the DRA node
    methods on ``plugin_socket``, the registration methods on
    ``registrar_socket``. ``call`` goes through this module's client
    over the real socket, so that callers written for
    ``kubeletplugin.LocalTransport`` work unchanged."""

    def __init__(self):
        self._servers: dict = {}        # "dra" / "registrar" -> Server
        self._channels: dict = {}
        self._lock = threading.Lock()

    @property
    def detail(self) -> str:
        if not self._servers:
            return "gRPC over unix sockets (not serving)"
        return (f"gRPC over unix sockets: dra={self._servers['dra'].path} "
                f"registrar={self._servers['registrar'].path}")

    def start(self, plugin) -> None:
        # Imported here: kubeletplugin imports this module for its default.
        from .kubeletplugin import method_table

        for path in (plugin.plugin_socket, plugin.registrar_socket):
            check_socket_path(path)
        prefix = f"/{REGISTRATION_SERVICE_NAME}/"
        table = method_table(plugin)
        servers = {
            "dra": Server(plugin.plugin_socket, {
                k: v for k, v in table.items() if not k.startswith(prefix)}),
            "registrar": Server(plugin.registrar_socket, {
                k: v for k, v in table.items() if k.startswith(prefix)}),
        }
        started = []
        try:
            for server in servers.values():
                started.append(server.start())
        except BaseException:
            for server in started:
                server.stop(grace=0)
            raise
        self._servers = servers

    def stop(self) -> None:
        with self._lock:
            channels, self._channels = list(self._channels.values()), {}
        for channel in channels:
            channel.close()
        servers, self._servers = list(self._servers.values()), {}
        for server in servers:
            server.stop()

    @property
    def serving(self) -> bool:
        return len(self._servers) == 2 and all(
            s.bound for s in self._servers.values())

    def socket_of(self, method_path: str) -> str:
        if not self._servers:
            raise RuntimeError("transport not serving")
        which = "registrar" if method_path.startswith(
            f"/{REGISTRATION_SERVICE_NAME}/") else "dra"
        return self._servers[which].path

    def call(self, method_path: str, request: bytes,
             timeout: Optional[float] = CALL_TIMEOUT_S) -> bytes:
        path = self.socket_of(method_path)
        with self._lock:
            channel = self._channels.get(path)
            if channel is None or not channel.usable:
                channel = self._channels[path] = Channel(path)
        return channel.call(method_path, request, timeout)
