"""Continuous-batching serving plane of the port: paged KV cache, block
allocator, scheduler, LoRA adapter pool, sampler and the engine."""
