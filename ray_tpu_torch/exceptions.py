"""Public exception types.

Mirrors the reference's `python/ray/exceptions.py` surface (RayError,
RayTaskError, RayActorError, GetTimeoutError, ObjectLostError, ...) so users
migrating from the reference find the same names and semantics.
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayError(Exception):
    """Base class for all framework exceptions."""


class RayTaskError(RayError):
    """A task raised; re-raised at `get` with the remote traceback attached.

    Reference: python/ray/exceptions.py RayTaskError — the remote exception is
    wrapped so the local traceback shows the remote one, and `cause` carries
    the original exception object when it was serializable.
    """

    def __init__(self, function_name: str, traceback_str: str,
                 cause: Optional[BaseException] = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(
            f"{function_name} failed with the below remote traceback:\n"
            f"{traceback_str}"
        )

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that is-a the cause's type (so `except ValueError`
        works across the task boundary, like the reference's dual-inheritance
        trick) while still carrying the remote traceback."""
        if self.cause is None:
            return self
        cause_cls = type(self.cause)
        if issubclass(RayTaskError, cause_cls):
            return self
        try:
            error_cls = type(
                "RayTaskError(" + cause_cls.__name__ + ")",
                (RayTaskError, cause_cls),
                {"__init__": lambda s: None},
            )
            err = error_cls()
            err.function_name = self.function_name
            err.traceback_str = self.traceback_str
            err.cause = self.cause
            err.args = (str(self),)
            return err
        except TypeError:
            return self

    def __reduce__(self):
        return (RayTaskError,
                (self.function_name, self.traceback_str, self.cause))

    @classmethod
    def from_exception(cls, function_name: str,
                       exc: BaseException) -> "RayTaskError":
        tb = "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(function_name, tb, cause=exc)


class TaskCancelledError(RayError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled")


class RayActorError(RayError):
    """The actor died before or during this call (reference: RayActorError)."""

    def __init__(self, actor_id=None, error_msg: str = "The actor died."):
        self.actor_id = actor_id
        self.error_msg = error_msg
        super().__init__(error_msg)

    def __reduce__(self):
        # Default Exception pickling replays __init__ with self.args =
        # (error_msg,) — which would land the MESSAGE in the actor_id
        # slot and reset the message to the default, destroying the
        # diagnostic the moment the error crosses a process boundary.
        return (type(self), (self.actor_id, self.error_msg))


class ActorDiedError(RayActorError):
    pass


class ActorUnavailableError(RayActorError):
    """Actor is temporarily unreachable (restarting); call may be retried."""


class GetTimeoutError(RayError, TimeoutError):
    pass


class ObjectStoreFullError(RayError):
    pass


class OutOfMemoryError(RayError):
    """A worker was killed by the node memory monitor (reference:
    worker_killing_policy.h + memory_monitor.h)."""


class ObjectLostError(RayError):
    def __init__(self, object_ref_hex: str = "", owner_address: str = ""):
        self.object_ref_hex = object_ref_hex
        super().__init__(
            f"Object {object_ref_hex} is lost (all copies failed and it could "
            "not be reconstructed from lineage)."
        )


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    def __init__(self, object_ref_hex: str = ""):
        ObjectLostError.__init__(self, object_ref_hex)
        self.args = (f"Object {object_ref_hex} is unavailable because its owner died.",)


class WorkerCrashedError(RayError):
    """The worker executing the task died unexpectedly (reference:
    WorkerCrashedError)."""


class RuntimeEnvSetupError(RayError):
    pass


class NodeDiedError(RayError):
    pass


class RaySystemError(RayError):
    pass


class CrossLanguageError(RayError):
    pass


class PendingCallsLimitExceeded(RayError):
    pass


__all__ = [
    "RayError", "RayTaskError", "TaskCancelledError", "RayActorError",
    "ActorDiedError", "ActorUnavailableError", "GetTimeoutError",
    "ObjectStoreFullError", "OutOfMemoryError", "ObjectLostError",
    "ObjectReconstructionFailedError", "OwnerDiedError",
    "RuntimeEnvSetupError", "NodeDiedError", "RaySystemError",
    "CrossLanguageError", "PendingCallsLimitExceeded",
]
