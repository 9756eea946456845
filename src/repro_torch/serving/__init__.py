"""Serving: continuous batching over a paged quantized KV cache
(counterpart of ``repro.serving``).

Lazy exports: ``engine`` imports the model stack, which imports
``paged_cache``; resolving names on demand keeps either import order
free of cycles.
"""
_EXPORTS = {
    "PagedKVCache": "paged_cache",
    "BlockAllocator": "paged_cache",
    "init_paged_cache": "paged_cache",
    "paged_append": "paged_cache",
    "paged_gather": "paged_cache",
    "request_words": "paged_cache",
    "Request": "engine",
    "EngineConfig": "engine",
    "ContinuousBatchingEngine": "engine",
    "RequestResult": "engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(f"repro_torch.serving.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module 'repro_torch.serving' has no attribute "
                         f"{name!r}")
