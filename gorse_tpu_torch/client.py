"""Python SDK client for the REST API (port of gorse_tpu/client.py).

Typed methods over the public endpoints, as gorse's Go SDK (client/) offers
them: insert, get and delete users, items and feedback; recommendations
with categories; session recommend; health. Stdlib urllib only.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request

from .storage.types import Feedback, Item, User


class GorseClient:
    def __init__(self, base_url: str, api_key: str = "", timeout: float = 30.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.timeout = timeout

    def _request(self, method: str, path: str, payload=None, query: dict | None = None):
        url = self.base_url + path
        if query:
            url += "?" + urllib.parse.urlencode(query, doseq=True)
        data = json.dumps(payload).encode() if payload is not None else None
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["X-API-Key"] = self.api_key
        req = urllib.request.Request(url, data=data, method=method, headers=headers)
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read().decode())

    # --- users
    def insert_user(self, user: User) -> dict:
        return self._request("POST", "/api/user", user.to_dict())

    def get_user(self, user_id: str) -> User:
        return User.from_dict(self._request("GET", f"/api/user/{urllib.parse.quote(user_id)}"))

    def delete_user(self, user_id: str) -> dict:
        return self._request("DELETE", f"/api/user/{urllib.parse.quote(user_id)}")

    def get_users(self, n: int = 10, cursor: str = "") -> tuple[list[User], str]:
        out = self._request("GET", "/api/users", query={"n": n, "cursor": cursor})
        return [User.from_dict(d) for d in out["Users"]], out["Cursor"]

    def update_user(self, user_id: str, patch: dict) -> dict:
        """Partial update (reference SDK: UpdateUser -> PATCH /api/user/{id})."""
        return self._request("PATCH", f"/api/user/{urllib.parse.quote(user_id)}", patch)

    # --- items
    def insert_item(self, item: Item) -> dict:
        return self._request("POST", "/api/item", item.to_dict())

    def get_item(self, item_id: str) -> Item:
        return Item.from_dict(self._request("GET", f"/api/item/{urllib.parse.quote(item_id)}"))

    def get_items(self, n: int = 10, cursor: str = "") -> tuple[list[Item], str]:
        out = self._request("GET", "/api/items", query={"n": n, "cursor": cursor})
        return [Item.from_dict(d) for d in out["Items"]], out["Cursor"]

    def update_item(self, item_id: str, patch: dict) -> dict:
        """Partial update (reference SDK: UpdateItem -> PATCH /api/item/{id})."""
        return self._request("PATCH", f"/api/item/{urllib.parse.quote(item_id)}", patch)

    def delete_item(self, item_id: str) -> dict:
        return self._request("DELETE", f"/api/item/{urllib.parse.quote(item_id)}")

    # --- feedback
    def insert_feedback(self, feedback: list[Feedback], overwrite: bool = False) -> dict:
        method = "PUT" if overwrite else "POST"
        return self._request(method, "/api/feedback", [f.to_dict() for f in feedback])

    def get_user_feedback(self, user_id: str, feedback_type: str = "") -> list[Feedback]:
        path = f"/api/user/{urllib.parse.quote(user_id)}/feedback"
        if feedback_type:
            path += f"/{urllib.parse.quote(feedback_type)}"
        return [Feedback.from_dict(d) for d in self._request("GET", path)]

    def list_feedbacks(self, feedback_type: str = "", n: int = 10, cursor: str = "") -> tuple[list[Feedback], str]:
        """Paged feedback scan (reference SDK: ListFeedbacks ->
        GET /api/feedback[/{type}])."""
        path = "/api/feedback" + (f"/{urllib.parse.quote(feedback_type)}" if feedback_type else "")
        out = self._request("GET", path, query={"n": n, "cursor": cursor})
        return [Feedback.from_dict(d) for d in out["Feedback"]], out["Cursor"]

    def delete_feedback(self, feedback_type: str, user_id: str, item_id: str) -> dict:
        """Delete one typed edge (reference SDK: DeleteFeedback ->
        DELETE /api/feedback/{type}/{user}/{item})."""
        return self._request(
            "DELETE",
            "/api/feedback/"
            f"{urllib.parse.quote(feedback_type)}/{urllib.parse.quote(user_id)}/{urllib.parse.quote(item_id)}",
        )

    def delete_feedbacks(self, user_id: str, item_id: str) -> list:
        """Delete every edge between a user and an item (reference SDK:
        DeleteFeedbacks -> DELETE /api/feedback/{user}/{item})."""
        return self._request(
            "DELETE",
            f"/api/feedback/{urllib.parse.quote(user_id)}/{urllib.parse.quote(item_id)}",
        )

    # --- recommendations
    def get_recommend(
        self,
        user_id: str,
        category: str = "",
        n: int = 10,
        offset: int = 0,
        write_back_type: str = "",
        write_back_delay: str = "",
    ) -> list[str]:
        path = f"/api/recommend/{urllib.parse.quote(user_id)}"
        if category:
            path += f"/{urllib.parse.quote(category)}"
        query = {"n": n, "offset": offset}
        if write_back_type:
            query["write-back-type"] = write_back_type
        if write_back_delay:
            query["write-back-delay"] = write_back_delay
        return self._request("GET", path, query=query)

    def get_latest(self, category: str = "", n: int = 10) -> list[dict]:
        """Returns scored documents [{"Id", "Score"}] like the reference SDK."""
        path = "/api/latest" + (f"/{urllib.parse.quote(category)}" if category else "")
        return self._request("GET", path, query={"n": n})

    def get_popular(self, category: str = "", n: int = 10) -> list[dict]:
        path = "/api/popular" + (f"/{urllib.parse.quote(category)}" if category else "")
        return self._request("GET", path, query={"n": n})

    def get_item_neighbors(self, item_id: str, n: int = 10) -> list[dict]:
        return self._request(
            "GET", f"/api/item/{urllib.parse.quote(item_id)}/neighbors", query={"n": n}
        )

    def session_recommend(self, feedback: list[Feedback], n: int = 10) -> list:
        return self._request(
            "POST", "/api/session/recommend", [f.to_dict() for f in feedback], query={"n": n}
        )

    def health_ready(self) -> bool:
        try:
            return self._request("GET", "/api/health/ready").get("status") == "ready"
        except Exception:  # noqa: BLE001
            return False
