"""Minimal OpenAI-compatible HTTP client (copy of gorse_tpu/llm/client.py).

Covers the reference's use of go-openai (logics/item_to_item.go:383-531,
logics/chat.go): chat completions + embeddings against any OpenAI-compatible
base URL, with RPM/TPM token-bucket limiting, exponential backoff on 429/5xx,
and the completion-parsing helpers (parseArrayFromCompletion
logics/chat.go:110, stripThinkInCompletion logics/item_to_item.go:533-542).

Token counting: the reference uses tiktoken cl100k_base; without network
access a chars/4 heuristic feeds the TPM limiter (documented divergence —
the limiter needs only an estimate).
"""

from __future__ import annotations

import json
import logging
import re
import time
import urllib.error
import urllib.request

from ..parallel.ratelimit import RateLimiters

logger = logging.getLogger(__name__)
openai_logger = logging.getLogger("gorse_tpu_torch.openai")  # dedicated prompt log


def estimate_tokens(text: str) -> int:
    return max(len(text) // 4, 1)


def strip_think(completion: str) -> str:
    """Remove <think>...</think> blocks emitted by reasoning models."""
    return re.sub(r"<think>.*?</think>", "", completion, flags=re.DOTALL).strip()


def parse_array_from_completion(completion: str) -> list[str]:
    """Extract a JSON array from a completion (reference: chat.go:110).

    JSON array -> elements as strings; JSON objects -> serialized; plain
    text -> the whole completion as a single element. Handles ```json fences.
    """
    completion = strip_think(completion)
    fence = re.search(r"```(?:json)?\s*(.*?)```", completion, flags=re.DOTALL)
    if fence:
        completion = fence.group(1).strip()
    # find the first [...] block
    m = re.search(r"\[.*\]", completion, flags=re.DOTALL)
    if m:
        try:
            arr = json.loads(m.group(0))
            if isinstance(arr, list):
                out = []
                for x in arr:
                    if isinstance(x, str):
                        out.append(x)
                    else:
                        out.append(json.dumps(x))
                return out
        except json.JSONDecodeError:
            pass
    return [completion] if completion else []


class OpenAIClient:
    def __init__(
        self,
        base_url: str,
        auth_token: str = "",
        chat_model: str = "",
        embedding_model: str = "",
        embedding_dimensions: int = 0,
        limiters: RateLimiters | None = None,
        max_retries: int = 5,
        timeout: float = 30.0,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.auth_token = auth_token
        self.chat_model = chat_model
        self.embedding_model = embedding_model
        self.embedding_dimensions = embedding_dimensions
        self.limiters = limiters or RateLimiters()
        self.max_retries = max_retries
        self.timeout = timeout

    def enabled(self) -> bool:
        return bool(self.base_url)

    def _post(self, path: str, payload: dict) -> dict:
        data = json.dumps(payload).encode()
        backoff = 1.0
        for attempt in range(self.max_retries):
            req = urllib.request.Request(
                self.base_url + path,
                data=data,
                headers={
                    "Content-Type": "application/json",
                    "Authorization": f"Bearer {self.auth_token}",
                },
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return json.loads(resp.read().decode())
            except urllib.error.HTTPError as e:
                if e.code in (429, 500, 502, 503) and attempt + 1 < self.max_retries:
                    time.sleep(backoff)
                    backoff *= 2
                    continue
                raise
            except urllib.error.URLError:
                if attempt + 1 < self.max_retries:
                    time.sleep(backoff)
                    backoff *= 2
                    continue
                raise
        raise RuntimeError("unreachable")

    def chat_completion(self, prompt: str, model: str | None = None) -> str:
        self.limiters.chat_requests.wait(1)
        self.limiters.chat_tokens.wait(estimate_tokens(prompt))
        resp = self._post(
            "/chat/completions",
            {
                "model": model or self.chat_model,
                "messages": [{"role": "user", "content": prompt}],
            },
        )
        content = resp["choices"][0]["message"]["content"]
        openai_logger.info("chat completion prompt=%r completion=%r", prompt, content)
        return content

    def chat_completion_raw(self, request: dict) -> dict:
        """Full chat-completion request passthrough (reference: the master's
        /api/chat/completions proxy, master/rest.go:2042-2127). The caller
        supplies the OpenAI request body; `model` defaults to the configured
        chat model; rate limits apply like any other chat call."""
        request = dict(request)
        request.setdefault("model", self.chat_model)
        if not request.get("model"):
            raise ValueError("missing chat completion model")
        prompt = json.dumps(request.get("messages", []))
        self.limiters.chat_requests.wait(1)
        self.limiters.chat_tokens.wait(estimate_tokens(prompt))
        request.pop("stream", None)  # upstream call is buffered; SSE framing
        # is reconstructed by the dashboard proxy
        return self._post("/chat/completions", request)

    def embedding(self, text: str, model: str | None = None) -> list[float]:
        self.limiters.embedding_requests.wait(1)
        self.limiters.embedding_tokens.wait(estimate_tokens(text))
        payload = {"model": model or self.embedding_model, "input": text}
        if self.embedding_dimensions:
            payload["dimensions"] = self.embedding_dimensions
        resp = self._post("/embeddings", payload)
        return resp["data"][0]["embedding"]

    @classmethod
    def from_config(cls, cfg) -> "OpenAIClient":
        """Build from utils.config.OpenAIConfig."""
        return cls(
            base_url=cfg.base_url,
            auth_token=cfg.auth_token,
            chat_model=cfg.chat_completion_model,
            embedding_model=cfg.embedding_model,
            embedding_dimensions=cfg.embedding_dimensions,
            limiters=RateLimiters(
                cfg.chat_completion_rpm,
                cfg.chat_completion_tpm,
                cfg.embedding_rpm,
                cfg.embedding_tpm,
            ),
        )
