"""Continuous-batching LLM inference engine, the port of
`ray_tpu.serve.engine`.

Two techniques composed into one loop:

- **iteration-level scheduling** (Orca, Yu et al. OSDI'22): admission,
  retirement and preemption decisions happen between every decode step
  — `scheduler.InferenceEngine`;
- **block-granular KV-cache management** (vLLM, Kwon et al. SOSP'23):
  fixed-size blocks in one preallocated buffer with per-sequence block
  tables — `kv_cache.KVCacheManager`.

Typical use on a card:

    from ray_tpu_torch.models import TransformerConfig, init_params
    from ray_tpu_torch.serve.engine import (EngineConfig, InferenceEngine,
                                            TransformerEngineModel)

    cfg = TransformerConfig(dtype=torch.float32)
    model = TransformerEngineModel(init_params(cfg), cfg)   # cuda:0
    engine = InferenceEngine(model, EngineConfig())   # paged decode
    engine.start()
    tokens = list(engine.submit(prompt, max_new_tokens=32))
"""

from ray_tpu_torch.serve.engine.kv_cache import (CacheOverflowError,
                                                 KVCacheManager)
from ray_tpu_torch.serve.engine.model import TinyLM, TransformerEngineModel
from ray_tpu_torch.serve.engine.prefix_index import PrefixIndex
from ray_tpu_torch.serve.engine.scheduler import (EngineConfig,
                                                  EngineOverloadedError,
                                                  EngineStoppedError,
                                                  InferenceEngine,
                                                  TokenStream)

__all__ = [
    "CacheOverflowError", "EngineConfig", "EngineOverloadedError",
    "EngineStoppedError", "InferenceEngine", "KVCacheManager",
    "PrefixIndex", "TinyLM", "TokenStream", "TransformerEngineModel",
]
