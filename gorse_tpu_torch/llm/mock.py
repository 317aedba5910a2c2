"""In-process fake OpenAI server for tests (copy of gorse_tpu/llm/mock.py).

Covers the reference's common/mock/openai.go (:30-150): deterministic
MD5-hash embeddings and echo chat completions (the ``deepseek-r1`` model
prefixes a <think> block to exercise think-stripping). Runs on an ephemeral
port; ``base_url`` plugs straight into OpenAIClient.
"""

from __future__ import annotations

import hashlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

AUTH_TOKEN = "ollama"


def hash_embedding(text: str, dimensions: int = 128) -> list[float]:
    """Deterministic pseudo-embedding (reference: mock.Hash
    common/mock/openai.go:144-150 — MD5 bits to floats, extended to any
    requested dimension by re-hashing)."""
    out: list[float] = []
    counter = 0
    while len(out) < dimensions:
        h = hashlib.md5(f"{text}\x00{counter}".encode()).digest()
        for b in h:
            out.append((b - 127.5) / 127.5)
            if len(out) == dimensions:
                break
        counter += 1
    return out


class MockOpenAIServer:
    def __init__(self, dimensions: int = 128) -> None:
        self.dimensions = dimensions
        self._httpd: ThreadingHTTPServer | None = None
        self.requests: list[dict] = []  # recorded for assertions
        # queued canned completions; when empty, echo the prompt
        self.completions: list[str] = []

    @property
    def base_url(self) -> str:
        assert self._httpd is not None
        return f"http://127.0.0.1:{self._httpd.server_port}/v1"

    @property
    def auth_token(self) -> str:
        return AUTH_TOKEN

    def queue_completion(self, content: str) -> None:
        self.completions.append(content)

    def start(self) -> "MockOpenAIServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length).decode() or "{}")
                server.requests.append({"path": self.path, "body": body})
                if self.path.endswith("/chat/completions"):
                    if server.completions:
                        content = server.completions.pop(0)
                    else:
                        content = body["messages"][0]["content"]
                    if body.get("model") == "deepseek-r1":
                        content = (
                            "<think>To be or not to be, that is the question.</think>"
                            + content
                        )
                    payload = {"choices": [{"message": {"content": content}}]}
                elif self.path.endswith("/embeddings"):
                    dims = int(body.get("dimensions") or server.dimensions)
                    payload = {
                        "data": [{"embedding": hash_embedding(str(body.get("input", "")), dims)}]
                    }
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                data = json.dumps(payload).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self

    def close(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd = None
