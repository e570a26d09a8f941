"""Node process supervisor: spawns and babysits GCS + raylet (the port of
`ray_tpu/core/node.py`, with GPUs where the reference has TPU chips and
without the dashboard, which waits for a later slice).

Reference equivalent: `python/ray/_private/node.py:38` (`Node`,
`start_gcs_server :1103`, `start_raylet :1134`, `start_head_processes
:1300`). Session layout mirrors the reference: a per-session directory with
process logs.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import subprocess
import tempfile
import sys
import time
from typing import Dict, Optional

from ray_tpu_torch.core.ids import NodeID


def detect_node_resources(num_cpus: Optional[int] = None,
                          num_gpus: Optional[int] = None,
                          resources: Optional[Dict[str, float]] = None
                          ) -> Dict[str, float]:
    """CPU/memory autodetection plus the node's GPUs, counted without
    initialising CUDA (`core/cuda_platform.py`); `num_gpus` overrides the
    count (the CPU tests fake cards that way)."""
    from ray_tpu_torch.core.cuda_platform import local_gpu_resources
    from ray_tpu_torch.core.memory_monitor import node_memory_usage

    out: Dict[str, float] = {}
    out["CPU"] = float(num_cpus if num_cpus is not None
                       else (os.cpu_count() or 1))
    out.update(local_gpu_resources())
    if num_gpus is not None:
        out.pop("GPU", None)
        if num_gpus:
            out["GPU"] = float(num_gpus)
    used, total = node_memory_usage()
    out["memory"] = float(total - used) if total > 1 else 4e9
    out.update(resources or {})
    return out


def _wait_for_line(proc: subprocess.Popen, pattern: str,
                   timeout: float = 30.0) -> str:
    """Read stdout lines until one matches `pattern`; returns the match."""
    regex = re.compile(pattern)
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"process exited with code {proc.returncode} before "
                    f"printing {pattern!r}")
            time.sleep(0.05)
            continue
        text = line.decode(errors="replace").strip()
        m = regex.search(text)
        if m:
            return m.group(1)
    raise TimeoutError(f"timed out waiting for {pattern!r}")


class NodeSupervisor:
    def __init__(self, session_dir: str):
        self.session_dir = session_dir
        self.log_dir = os.path.join(session_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self.processes: Dict[str, subprocess.Popen] = {}
        self.gcs_address: Optional[str] = None
        self.raylet_address: Optional[str] = None
        self.dashboard_address: Optional[str] = None
        self.node_id: Optional[str] = None
        atexit.register(self.stop)

    # -- head bring-up (reference: node.py start_head_processes) ---------
    @classmethod
    def start_head(cls, num_cpus=None, num_gpus=None, resources=None,
                   object_store_memory=None,
                   session_root: Optional[str] = None,
                   include_dashboard: bool = False) -> "NodeSupervisor":
        root = session_root or os.path.join(tempfile.gettempdir(),
                                            "ray_tpu_torch_sessions")
        session_dir = os.path.join(
            root, f"session_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}")
        node = cls(session_dir)
        node._start_gcs()
        node._start_raylet(
            detect_node_resources(num_cpus, num_gpus, resources),
            object_store_memory, is_head=True)
        if include_dashboard:
            raise NotImplementedError(
                "the dashboard comes with a later slice of the port")
        return node

    def _child_env(self) -> dict:
        env = dict(os.environ)
        env["RAY_TPU_LOG_DIR"] = self.log_dir
        # Workers map their lease's instance ids through the node's own
        # card list (the raylet starts each with CUDA_VISIBLE_DEVICES="").
        from ray_tpu_torch.core.cuda_platform import node_env

        node_env(env)
        # The daemons run `-m ray_tpu_torch...` from wherever the driver
        # imported this package.
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        paths = env.get("PYTHONPATH", "").split(os.pathsep)
        if root not in paths:
            env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in paths
                                                          if p])
        return env

    def _spawn(self, name: str, cmd, pattern: str) -> str:
        log = open(os.path.join(self.log_dir, f"{name}.err"), "ab")
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=log,
                                env=self._child_env())
        self.processes[name] = proc
        return _wait_for_line(proc, pattern)

    def _start_gcs(self) -> None:
        self.gcs_address = self._spawn(
            "gcs", [sys.executable, "-m", "ray_tpu_torch.core.gcs.server",
                    "--storage",
                    os.path.join(self.session_dir, "gcs_storage.pkl")],
            r"GCS_ADDRESS=(\S+)")

    def _start_raylet(self, resources: Dict[str, float],
                      object_store_memory: Optional[int],
                      is_head: bool = False) -> None:
        self.node_id = NodeID.from_random().hex()
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.raylet",
               "--gcs", self.gcs_address, "--node-id", self.node_id,
               "--resources", json.dumps(resources)]
        if object_store_memory:
            cmd += ["--object-store-memory", str(object_store_memory)]
        if is_head:
            cmd += ["--head"]
        self.raylet_address = self._spawn(
            "raylet", cmd, r"RAYLET_ADDRESS=(\S+)")

    def kill_gcs(self) -> None:
        """Fault injection: hard-kill the GCS process (reference:
        test_gcs_fault_tolerance.py)."""
        proc = self.processes["gcs"]
        proc.kill()
        proc.wait()

    def restart_gcs(self) -> None:
        """Bring the GCS back at the SAME address with its persisted
        storage; raylets re-register via the heartbeat False-reply
        contract, clients reconnect via _ReconnectingRpc."""
        host, port = self.gcs_address.rsplit(":", 1)
        addr = self._spawn(
            "gcs", [sys.executable, "-m", "ray_tpu_torch.core.gcs.server",
                    "--host", host, "--port", port, "--storage",
                    os.path.join(self.session_dir, "gcs_storage.pkl")],
            r"GCS_ADDRESS=(\S+)")
        assert addr == self.gcs_address, (addr, self.gcs_address)

    def stop(self) -> None:
        for name, proc in reversed(list(self.processes.items())):
            if proc.poll() is None:
                proc.terminate()
        deadline = time.time() + 3
        for proc in self.processes.values():
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
        self.processes.clear()
