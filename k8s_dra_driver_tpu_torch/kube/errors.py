"""Kubernetes API error model.

Role of apimachinery's errors package as used by the reference (e.g.
`errors.IsNotFound` in lengrongfu/k8s-dra-driver
cmd/nvidia-dra-plugin/sharing.go:380-383): a small typed hierarchy so callers
can branch on status codes without string matching.
"""

from __future__ import annotations


class ApiError(Exception):
    """An error returned by the Kubernetes API (or the fake)."""

    code = 500
    reason = "InternalError"

    def __init__(
        self,
        message: str = "",
        code: int | None = None,
        retry_after: float | None = None,
    ):
        super().__init__(message or self.reason)
        if code is not None:
            self.code = code
        # Server-suggested retry delay (the Retry-After header a real API
        # server attaches to 429/503 under priority-and-fairness load
        # shedding); None when the server sent none.
        self.retry_after = retry_after

    @property
    def status(self) -> dict:
        return {
            "kind": "Status",
            "apiVersion": "v1",
            "status": "Failure",
            "message": str(self),
            "reason": self.reason,
            "code": self.code,
        }


class NotFoundError(ApiError):
    code = 404
    reason = "NotFound"


class AlreadyExistsError(ApiError):
    code = 409
    reason = "AlreadyExists"


class ConflictError(ApiError):
    """resourceVersion mismatch on update."""

    code = 409
    reason = "Conflict"


class InvalidError(ApiError):
    code = 422
    reason = "Invalid"


def is_not_found(err: Exception) -> bool:
    return isinstance(err, NotFoundError)


def is_conflict(err: Exception) -> bool:
    return isinstance(err, (ConflictError, AlreadyExistsError))
