"""In-process object-store servers: MiniS3, MiniGCS, MiniAzure (copy of
gorse_tpu/storage/miniobj.py).

Each verifies the request signatures (SigV4 / SharedKey) by re-deriving
them with the known secret, so the signers of storage/object.py are
genuinely exercised. Listings paginate (2 keys per page) to exercise the
clients' continuation-token loops."""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from xml.sax.saxutils import escape

from .object import azure_shared_key_sign, sigv4_sign

PAGE = 2  # keys per list page — small to force pagination in tests


class _MiniObjectServer:
    """Shared plumbing: a ThreadingHTTPServer over a dict[str, bytes]."""

    def __init__(self, handler_cls) -> None:
        self.objects: dict[str, bytes] = {}
        self.lock = threading.Lock()
        server = self

        class Handler(handler_cls):
            mini = server

            def log_message(self, fmt, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def start(self) -> "_MiniObjectServer":
        self.thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


class _BaseHandler(BaseHTTPRequestHandler):
    mini: _MiniObjectServer
    disable_nagle_algorithm = True  # the body leaves with the headers

    def _reply(self, status: int, body: bytes = b"", ctype: str = "application/xml") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""


# ---------------------------------------------------------------------------
# MiniS3
# ---------------------------------------------------------------------------


class _S3Handler(_BaseHandler):
    def _verify(self, body: bytes) -> bool:
        auth = self.headers.get("Authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            return False
        fields = dict(
            kv.strip().split("=", 1) for kv in auth[len("AWS4-HMAC-SHA256 "):].split(",")
        )
        signed = fields.get("SignedHeaders", "").split(";")
        cred = fields.get("Credential", "").split("/")
        if cred[0] != self.mini.access_key or len(cred) < 5:  # type: ignore[attr-defined]
            return False
        headers = {name: self.headers.get(name, "") for name in signed}
        raw_path, _, raw_query = self.path.partition("?")
        query = dict(urllib.parse.parse_qsl(raw_query, keep_blank_values=True))
        expect = sigv4_sign(
            self.command,
            urllib.parse.unquote(raw_path),
            query,
            headers,
            body,
            self.mini.access_key,  # type: ignore[attr-defined]
            self.mini.secret_key,  # type: ignore[attr-defined]
            cred[2],
            self.headers.get("x-amz-date", ""),
        )
        return expect.rsplit("Signature=", 1)[-1] == fields.get("Signature", "")

    def _key(self) -> str:
        path = urllib.parse.unquote(self.path.partition("?")[0]).lstrip("/")
        return path.partition("/")[2]  # strip bucket

    def do_PUT(self):
        body = self._read_body()
        if not self._verify(body):
            return self._reply(403, b"<Error><Code>SignatureDoesNotMatch</Code></Error>")
        with self.mini.lock:
            self.mini.objects[self._key()] = body
        self._reply(200)

    def do_DELETE(self):
        if not self._verify(b""):
            return self._reply(403)
        with self.mini.lock:
            self.mini.objects.pop(self._key(), None)
        self._reply(204)

    def do_GET(self):
        if not self._verify(b""):
            return self._reply(403)
        _, _, raw_query = self.path.partition("?")
        query = dict(urllib.parse.parse_qsl(raw_query, keep_blank_values=True))
        if query.get("list-type") == "2":
            prefix = query.get("prefix", "")
            with self.mini.lock:
                keys = sorted(k for k in self.mini.objects if k.startswith(prefix))
            start = int(query.get("continuation-token") or 0)
            page = keys[start : start + PAGE]
            truncated = start + PAGE < len(keys)
            xml = ['<ListBucketResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">']
            xml.append(f"<IsTruncated>{'true' if truncated else 'false'}</IsTruncated>")
            if truncated:
                xml.append(f"<NextContinuationToken>{start + PAGE}</NextContinuationToken>")
            for k in page:
                xml.append(f"<Contents><Key>{escape(k)}</Key></Contents>")
            xml.append("</ListBucketResult>")
            return self._reply(200, "".join(xml).encode())
        with self.mini.lock:
            data = self.mini.objects.get(self._key())
        if data is None:
            return self._reply(404, b"<Error><Code>NoSuchKey</Code></Error>")
        self._reply(200, data, "application/octet-stream")


class MiniS3(_MiniObjectServer):
    def __init__(self, access_key: str = "minio", secret_key: str = "miniosecret") -> None:
        super().__init__(_S3Handler)
        self.access_key, self.secret_key = access_key, secret_key

    def url(self, bucket: str = "gorse", prefix: str = "") -> str:
        p = f"/{prefix}" if prefix else ""
        return (
            f"s3://{self.access_key}:{self.secret_key}@127.0.0.1:{self.port}"
            f"/{bucket}{p}?region=us-east-1&secure=false"
        )


# ---------------------------------------------------------------------------
# MiniGCS
# ---------------------------------------------------------------------------


class _GCSHandler(_BaseHandler):
    def _verify(self) -> bool:
        token = self.mini.token  # type: ignore[attr-defined]
        return not token or self.headers.get("Authorization") == f"Bearer {token}"

    def do_POST(self):
        body = self._read_body()
        if not self._verify():
            return self._reply(401, b"{}", "application/json")
        raw_path, _, raw_query = self.path.partition("?")
        query = dict(urllib.parse.parse_qsl(raw_query))
        name = query.get("name", "")
        with self.mini.lock:
            self.mini.objects[name] = body
        self._reply(200, json.dumps({"name": name}).encode(), "application/json")

    def do_GET(self):
        if not self._verify():
            return self._reply(401, b"{}", "application/json")
        raw_path, _, raw_query = self.path.partition("?")
        query = dict(urllib.parse.parse_qsl(raw_query))
        parts = raw_path.split("/o", 1)
        tail = parts[1] if len(parts) > 1 else ""
        if tail.startswith("/"):  # object download
            name = urllib.parse.unquote(tail[1:])
            with self.mini.lock:
                data = self.mini.objects.get(name)
            if data is None:
                return self._reply(404, b"{}", "application/json")
            return self._reply(200, data, "application/octet-stream")
        prefix = query.get("prefix", "")
        with self.mini.lock:
            keys = sorted(k for k in self.mini.objects if k.startswith(prefix))
        start = int(query.get("pageToken") or 0)
        page = keys[start : start + PAGE]
        doc: dict = {"items": [{"name": k} for k in page]}
        if start + PAGE < len(keys):
            doc["nextPageToken"] = str(start + PAGE)
        self._reply(200, json.dumps(doc).encode(), "application/json")

    def do_DELETE(self):
        if not self._verify():
            return self._reply(401, b"{}", "application/json")
        name = urllib.parse.unquote(self.path.partition("?")[0].split("/o/", 1)[-1])
        with self.mini.lock:
            self.mini.objects.pop(name, None)
        self._reply(204, b"", "application/json")


class MiniGCS(_MiniObjectServer):
    def __init__(self, token: str = "fake-gcs-token") -> None:
        super().__init__(_GCSHandler)
        self.token = token

    def url(self, bucket: str = "gorse", prefix: str = "") -> str:
        p = f"/{prefix}" if prefix else ""
        return f"gs://{bucket}{p}?endpoint=127.0.0.1:{self.port}&token={self.token}"


# ---------------------------------------------------------------------------
# MiniAzure
# ---------------------------------------------------------------------------


class _AzureHandler(_BaseHandler):
    def _verify(self, body: bytes) -> bool:
        auth = self.headers.get("Authorization", "")
        if not auth.startswith("SharedKey "):
            return False
        raw_path, _, raw_query = self.path.partition("?")
        query = dict(urllib.parse.parse_qsl(raw_query, keep_blank_values=True))
        headers = {
            k: v for k, v in self.headers.items() if k.lower().startswith("x-ms-")
        }
        if self.headers.get("Content-Type"):
            headers["Content-Type"] = self.headers["Content-Type"]
        expect = azure_shared_key_sign(
            self.mini.account,  # type: ignore[attr-defined]
            self.mini.key_b64,  # type: ignore[attr-defined]
            self.command,
            urllib.parse.unquote(raw_path),
            query,
            headers,
            len(body),
        )
        return auth == expect

    def _key(self) -> str:
        path = urllib.parse.unquote(self.path.partition("?")[0]).lstrip("/")
        return path.partition("/")[2]  # strip container

    def do_PUT(self):
        body = self._read_body()
        if not self._verify(body):
            return self._reply(403)
        with self.mini.lock:
            self.mini.objects[self._key()] = body
        self._reply(201)

    def do_DELETE(self):
        if not self._verify(b""):
            return self._reply(403)
        with self.mini.lock:
            self.mini.objects.pop(self._key(), None)
        self._reply(202)

    def do_GET(self):
        if not self._verify(b""):
            return self._reply(403)
        _, _, raw_query = self.path.partition("?")
        query = dict(urllib.parse.parse_qsl(raw_query, keep_blank_values=True))
        if query.get("comp") == "list":
            prefix = query.get("prefix", "")
            with self.mini.lock:
                keys = sorted(k for k in self.mini.objects if k.startswith(prefix))
            start = int(query.get("marker") or 0)
            page = keys[start : start + PAGE]
            marker = str(start + PAGE) if start + PAGE < len(keys) else ""
            xml = ["<EnumerationResults><Blobs>"]
            for k in page:
                xml.append(f"<Blob><Name>{escape(k)}</Name></Blob>")
            xml.append(f"</Blobs><NextMarker>{marker}</NextMarker></EnumerationResults>")
            return self._reply(200, "".join(xml).encode())
        with self.mini.lock:
            data = self.mini.objects.get(self._key())
        if data is None:
            return self._reply(404)
        self._reply(200, data, "application/octet-stream")


class MiniAzure(_MiniObjectServer):
    def __init__(self, account: str = "devstoreaccount1", key_b64: str = "a2V5a2V5a2V5") -> None:
        super().__init__(_AzureHandler)
        self.account, self.key_b64 = account, key_b64

    def url(self, container: str = "gorse", prefix: str = "") -> str:
        p = f"/{prefix}" if prefix else ""
        return (
            f"azblob://{self.account}:{urllib.parse.quote(self.key_b64, safe='')}"
            f"@127.0.0.1:{self.port}/{container}{p}?secure=false"
        )
