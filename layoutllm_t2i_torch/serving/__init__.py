"""Serving: a micro-batched HTTP request server around InferencePipeline
(layoutllm_t2i_tpu/serving/)."""
from .batcher import MicroBatcher  # noqa: F401
