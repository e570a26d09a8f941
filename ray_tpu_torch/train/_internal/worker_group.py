"""WorkerGroup: the gang of training actors, the port of
`ray_tpu/train/_internal/worker_group.py`.

Reference: `python/ray/train/_internal/worker_group.py:102` — a list of
actors with execute/execute_single helpers. Workers carry GPU resources
and report node metadata, from which the backend numbers local ranks.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch


def host_ip() -> str:
    """This host's address for the gang's rendezvous (loopback where the
    host name does not resolve)."""
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


class TrainWorker:
    """Actor body hosting one training process (reference:
    worker_group.py RayTrainWorker)."""

    def __init__(self):
        self._session = None
        self._thread = None

    # -- introspection --------------------------------------------------
    def metadata(self) -> Dict[str, Any]:
        ctx = ray_tpu_torch.get_runtime_context()
        return {
            "node_id": ctx.get_node_id(),
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "ip": host_ip(),
        }

    def execute(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Run an arbitrary function in the worker process (backend hooks)."""
        return fn(*args, **kwargs)

    def ping(self) -> bool:
        """Liveness probe used by the executor while results are pending."""
        return True

    # -- training loop --------------------------------------------------
    def start_training(self, train_fn, config: Optional[dict],
                       *, world_rank: int, local_rank: int, world_size: int,
                       node_rank: int, trial_name: str = "",
                       checkpoint=None, dataset_shard=None,
                       profile_steps=None, profile_dir=None) -> bool:
        import threading

        from ray_tpu_torch.air.session import (_StopTraining, _TrainSession,
                                         _set_session)

        if isinstance(train_fn, bytes):  # the trainer's dumps() blob
            from ray_tpu_torch.core.serialization import loads

            train_fn = loads(train_fn)

        session = _TrainSession(
            world_rank=world_rank, local_rank=local_rank,
            world_size=world_size, node_rank=node_rank,
            trial_name=trial_name, checkpoint=checkpoint,
            dataset_shard=dataset_shard, profile_steps=profile_steps,
            profile_dir=profile_dir)
        self._session = session
        _set_session(session)

        import inspect

        takes_config = bool(inspect.signature(train_fn).parameters)

        def run():
            try:
                if takes_config:
                    final = train_fn(config if config is not None else {})
                else:
                    final = train_fn()
                session.finish(final=final)
            except _StopTraining:
                session.finish()
            except BaseException as e:  # noqa: BLE001
                session.finish(error=e)
            finally:
                # The gang is killed right after results drain: push the
                # final train_* histogram state to the raylet now or the
                # last steps never reach the dashboard's /metrics.
                from ray_tpu_torch.util.metrics import flush_metrics_push

                flush_metrics_push()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="train-loop")
        self._thread.start()
        return True

    def next_result(self) -> Dict[str, Any]:
        """Block until the user loop reports, finishes, or errors.
        Consuming a report unblocks the worker's `session.report`."""
        import queue as _q

        session = self._session
        if session is None:
            raise RuntimeError("start_training was never called")
        while True:
            try:
                item = session.result_queue.get(timeout=0.05)
                session.continue_event.set()
                return item
            except _q.Empty:
                if session.finished:
                    if session.error is not None:
                        raise session.error
                    return {"type": "done", "final": session.final_return}

    def stop_training(self) -> bool:
        if self._session is not None:
            self._session.stop_requested = True
            self._session.continue_event.set()
        return True


class WorkerGroup:
    """Spawns and addresses the actor gang (reference:
    worker_group.py:102 WorkerGroup)."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 placement_group=None):
        resources = dict(resources_per_worker or {"CPU": 1.0})
        num_cpus = resources.pop("CPU", 1.0)
        opts: Dict[str, Any] = {"num_cpus": num_cpus,
                                "max_concurrency": 8,
                                "max_restarts": 0}
        if resources:
            opts["resources"] = resources
        cls = ray_tpu_torch.remote(**opts)(TrainWorker)
        if placement_group is not None:
            # Worker i lives in bundle i when the group has one bundle per
            # worker (ScalingConfig.as_placement_group_factory); otherwise
            # let the group round-robin (-1 = any bundle).
            n_bundles = getattr(placement_group, "bundle_count", 0)
            self.workers = [
                cls.options(
                    placement_group=placement_group,
                    placement_group_bundle_index=(
                        i if n_bundles == num_workers else -1),
                ).remote()
                for i in range(num_workers)]
        else:
            self.workers = [cls.remote() for _ in range(num_workers)]
        self.metadata: List[Dict[str, Any]] = ray_tpu_torch.get(
            [w.metadata.remote() for w in self.workers], timeout=120)
        # Deterministic rank order: group by node, stable by pid
        # (reference sorts workers by node IP for rank assignment).
        order = sorted(range(num_workers),
                       key=lambda i: (self.metadata[i]["node_id"],
                                      self.metadata[i]["pid"]))
        self.workers = [self.workers[i] for i in order]
        self.metadata = [self.metadata[i] for i in order]

    def __len__(self) -> int:
        return len(self.workers)

    def execute(self, fn: Callable, *args: Any, **kwargs: Any) -> List[Any]:
        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs),
                           timeout=600)

    def execute_async(self, fn: Callable, *args: Any, **kwargs: Any):
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute_single(self, index: int, fn: Callable, *args: Any,
                       **kwargs: Any) -> Any:
        return ray_tpu_torch.get(
            self.workers[index].execute.remote(fn, *args, **kwargs),
            timeout=600)

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
