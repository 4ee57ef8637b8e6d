"""paddle_tpu_torch.inference — the serving engines.

Counterpart of the serving half of ``paddle_tpu/inference/``: the fused
causal LM, the generation and continuous-batching engines and the
paged KV block manager, and speculative decoding (drafters and the
batched verify pass). The jit-artifact predictor API of the JAX package
is not part of this slice.
"""
from __future__ import annotations

from .engine import (DEFAULT_DECODE_CHUNK, ContinuousBatchingEngine,
                     FusedCausalLM, GenerationEngine, GenRequest)
from .kv_cache import BlockKVCacheManager
from .speculative import (Drafter, DraftModelDrafter, ScheduledDrafter,
                          SelfDraftHeads, SpeculativeDecoder,
                          build_speculative_decoder)

__all__ = ["FusedCausalLM", "GenerationEngine", "BlockKVCacheManager",
           "ContinuousBatchingEngine", "GenRequest", "DEFAULT_DECODE_CHUNK",
           "Drafter", "DraftModelDrafter", "SelfDraftHeads",
           "ScheduledDrafter", "SpeculativeDecoder",
           "build_speculative_decoder"]
