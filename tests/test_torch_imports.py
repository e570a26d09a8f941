"""Package rule: no module of `ray_tpu_torch` imports `jax`, `optax` or
anything of `ray_tpu`. A child interpreter imports every module of the
package (its `__main__` guards keep entry points from running) and lists
what landed in `sys.modules`."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib, json, pkgutil, sys
import ray_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    ray_tpu_torch.__path__, "ray_tpu_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "ray_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_no_module_of_the_port_imports_jax_optax_or_ray_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True,
                         text=True, timeout=180, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"ray_tpu_torch.rllib.algorithms.impala",
            "ray_tpu_torch.rllib.bench", "ray_tpu_torch.models.cnn",
            "ray_tpu_torch.models.mlp", "ray_tpu_torch.rllib.algorithms.dqn",
            "ray_tpu_torch.rllib.algorithms.multi_agent_ppo",
            "ray_tpu_torch.rllib.env.multi_agent_env",
            "ray_tpu_torch.rllib.utils.replay_buffers",
            "ray_tpu_torch.util.queue", "ray_tpu_torch.util.multiprocessing",
            "ray_tpu_torch.util.state"} <= set(result["modules"])
    assert len(result["modules"]) > 100
    assert result["bad"] == []
