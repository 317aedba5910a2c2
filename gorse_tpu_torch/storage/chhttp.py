"""ClickHouse HTTP-interface client (copy of gorse_tpu/storage/chhttp.py).

Queries are POSTed with ``FORMAT JSONCompactEachRow`` results and
authenticated by the X-ClickHouse-User/Key headers. No driver
dependency."""

from __future__ import annotations

import http.client
import json
import threading
import urllib.parse

__all__ = ["ClickHouseConnection", "ClickHouseError"]


class ClickHouseError(Exception):
    pass


class ClickHouseConnection:
    def __init__(
        self,
        host: str,
        port: int = 8123,
        user: str = "default",
        password: str = "",
        database: str = "default",
        timeout: float = 30.0,
    ) -> None:
        self.host, self.port = host, port
        self.user, self.password, self.database = user, password, database
        self.timeout = timeout
        self._lock = threading.Lock()

    def _request(self, sql: str) -> bytes:
        qs = urllib.parse.urlencode({"database": self.database})
        conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            conn.request(
                "POST",
                f"/?{qs}",
                body=sql.encode(),
                headers={
                    "X-ClickHouse-User": self.user,
                    "X-ClickHouse-Key": self.password,
                    "Content-Type": "text/plain",
                },
            )
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise ClickHouseError(
                    f"HTTP {resp.status}: {body[:300].decode(errors='replace')}"
                )
            return body
        finally:
            conn.close()

    def query(self, sql: str) -> list[tuple]:
        """Run a statement; SELECTs get ``FORMAT JSONCompactEachRow`` appended
        (one JSON array per line → typed values for free)."""
        with self._lock:
            head = sql.lstrip()[:6].upper()
            is_select = head in ("SELECT", "SHOW T", "SHOW D")
            # suffix check, not substring: interpolated literals may contain
            # the word FORMAT
            if is_select and not sql.rstrip().upper().endswith("JSONCOMPACTEACHROW"):
                sql += " FORMAT JSONCompactEachRow"
            body = self._request(sql)
        if not is_select:
            return []
        rows = []
        for line in body.splitlines():
            if line.strip():
                rows.append(tuple(json.loads(line)))
        return rows

    def ping(self) -> bool:
        try:
            self.query("SELECT 1")
            return True
        except Exception:
            return False

    def close(self) -> None:
        pass
