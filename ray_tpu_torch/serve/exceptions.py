"""Serve exceptions (reference: python/ray/serve/exceptions.py)."""


class RayServeException(Exception):
    pass


class ReplicaDrainingError(RayServeException):
    """Request landed on a replica that is shutting down; the router
    retries on another replica."""


class DeploymentUnavailableError(RayServeException):
    """No running replica for the deployment (still starting, or all
    replicas died)."""
