"""Socket helpers of the serving tests: every socket has a timeout, and a
response is read by its own framing (the header block, then
Content-Length bytes) or until the server closes, never by one recv()."""

import http.client
import json
import socket

TIMEOUT = 30


def request(port, method, path, body=None, headers=None):
    """``(status, body bytes, content type)`` of one request on a fresh
    connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read(), r.getheader("Content-Type")
    finally:
        conn.close()


def raw_exchange(port, payload: bytes, timeout: float = TIMEOUT) -> bytes:
    """Send ``payload`` and read one response: the header block and its
    Content-Length of body, or whatever arrives before the server closes
    or ``timeout`` passes with nothing more."""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        s.sendall(payload)
        data = b""
        while True:
            head, sep, rest = data.partition(b"\r\n\r\n")
            if sep:
                length = 0
                for line in head.split(b"\r\n")[1:]:
                    name, _, value = line.partition(b":")
                    if name.strip().lower() == b"content-length":
                        length = int(value.strip())
                if len(rest) >= length:
                    return data
            try:
                chunk = s.recv(65536)
            except socket.timeout:
                return data
            if not chunk:
                return data
            data += chunk
    finally:
        s.close()


def status_line(data: bytes) -> str:
    return data.split(b"\r\n", 1)[0].decode("latin-1")


def body_json(data: bytes):
    return json.loads(data.partition(b"\r\n\r\n")[2])


def healthy(port) -> bool:
    status, body, _ = request(port, "GET", "/healthz")
    return status == 200 and json.loads(body).get("status") == "ok"
