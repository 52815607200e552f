"""Model and executor construction from the config (counterpart of
``build_model``/``build_executor`` in ``list_tpu/train/trainer.py``; the
epoch driver is not ported yet)."""

from __future__ import annotations

from list_tpu_torch import registry


def build_model(config):
    model_cls = registry.get_class(config.model)
    if hasattr(model_cls, 'from_config'):
        return model_cls.from_config(config)
    return model_cls(config)


def build_executor(config, model, **kw):
    exec_cls = registry.get_class(registry.executor_for(config.model))
    return exec_cls(config, model, **kw)
