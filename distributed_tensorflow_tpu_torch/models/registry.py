"""Tiny model registry so ``--model`` can select architectures by name."""

from __future__ import annotations

_REGISTRY: dict[str, type] = {}


def register_model(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def get_model(name: str, **kwargs):
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return cls(**kwargs)


def available_models():
    return sorted(_REGISTRY)
