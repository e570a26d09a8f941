"""The deployments that the port's multiplex, gRPC and tracing tests
(`test_torch_serve_multiplex.py`, `test_torch_grpc.py`,
`test_torch_tracing.py`) run, in the test process's in-process runtime and
in the replica processes of the port's cluster.

This module imports neither jax nor torch at its top: the port's replica
processes import it to find the classes a test deploys (the port sends
them by reference). `Adapters`, `Affinity` and `Echo` are the deployments
of `tests/test_serve_multiplex_grpc.py`, on the port's Serve.
"""

import os

from ray_tpu_torch import serve


class Adapters:
    """Multiplexed deployment: tracks every model load per replica."""

    def __init__(self):
        self.loads = []

    @serve.multiplexed(max_num_models_per_replica=2)
    async def get_model(self, model_id: str):
        self.loads.append(model_id)
        return {"id": model_id, "scale": len(model_id)}

    async def __call__(self, x):
        model = await self.get_model(serve.get_multiplexed_model_id())
        return {"model": model["id"], "y": x * model["scale"],
                "loads": list(self.loads)}


class Affinity:
    def __init__(self):
        self.pid = os.getpid()
        self.loaded = []

    @serve.multiplexed(max_num_models_per_replica=4)
    async def get_model(self, model_id: str):
        self.loaded.append(model_id)
        return model_id

    async def __call__(self, _):
        await self.get_model(serve.get_multiplexed_model_id())
        return {"pid": self.pid, "loaded": list(self.loaded)}


class Echo:
    async def __call__(self, x, mult=1):
        return {"x": x * mult}

    async def tagged(self, x):
        return {"tag": serve.get_multiplexed_model_id(), "x": x}

    def count(self, n):
        yield from range(n)

    def pid(self):
        return os.getpid()


class TinyEngine:
    """One model id's small transformer and its engine. The engine's
    scheduler thread holds the engine, so dropping this object stops
    it: then nothing holds the model's tensors."""

    def __init__(self, np_params, tiny, engine):
        import torch

        from ray_tpu_torch.models import TransformerConfig, params_from_jax
        from ray_tpu_torch.serve.engine import (EngineConfig,
                                                InferenceEngine,
                                                TransformerEngineModel)

        cfg = TransformerConfig(dtype=torch.float32, **tiny)
        model = TransformerEngineModel(params_from_jax(np_params, "cpu"),
                                       cfg, device="cpu")
        self.engine = InferenceEngine(model, EngineConfig(**engine))
        self.engine.start()

    def __del__(self):
        self.engine.stop()


class MuxTiny:
    """A multiplexed deployment of the small transformer: model id ->
    its parameters (numpy, the reference's layout), at most two engines
    resident."""

    def __init__(self, np_params_by_id, tiny, engine):
        self.params = np_params_by_id
        self.tiny, self.engine_config = tiny, engine
        self.loads = []

    @serve.multiplexed(max_num_models_per_replica=2)
    async def get_model(self, model_id: str):
        self.loads.append(model_id)
        return TinyEngine(self.params[model_id], self.tiny,
                          self.engine_config)

    async def generate(self, req):
        model = await self.get_model(serve.get_multiplexed_model_id())
        stream = model.engine.submit(req["prompt"], req["max_new_tokens"])
        async for tok in stream:
            yield tok

    def load_log(self):
        return list(self.loads)
