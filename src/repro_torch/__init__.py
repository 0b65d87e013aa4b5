"""repro_torch — the PyTorch/CUDA port of the FedSAE reproduction.

The JAX package ``repro`` is the reference; this package imports neither
JAX nor anything of ``repro``.  Typical use:

    from repro_torch import FedSAEServer, ServerConfig
    from repro_torch.data.federated import make_femnist_like

    srv = FedSAEServer(make_femnist_like(), cfg=ServerConfig(
        rounds=50, sampling="iid"))          # device defaults to cuda
    hist = srv.run()

    from repro_torch import build_model, get_config
    from repro_torch.launch.serve import generate, prompt_batch

    cfg = get_config("llama3.2-3b")         # full width; smoke=True: tiny
    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    out, logits, times = generate(model, params,
                                  prompt_batch(cfg, 4, 2048, "cuda"), 32)

Every attribute resolves lazily (PEP 562), as in ``repro``: importing the
package pulls in nothing heavy.
"""
from __future__ import annotations

#: public name -> defining module
_EXPORTS = {
    "FedSAEServer": "repro_torch.core.server",
    "ServerConfig": "repro_torch.core.server",
    "ComputeConfig": "repro_torch.core.server",
    "CommConfig": "repro_torch.core.server",
    "RobustnessConfig": "repro_torch.core.server",
    "RoundEngine": "repro_torch.core.engine",
    "LocalStep": "repro_torch.models.fl_models",
    "as_local_step": "repro_torch.models.fl_models",
    "resolve_local_step": "repro_torch.models.fl_models",
    "FederatedDataset": "repro_torch.data.federated",
    "params_from_reference": "repro_torch.convert",
    "params_to_numpy": "repro_torch.convert",
    "get_config": "repro_torch.configs.base",
    "build_model": "repro_torch.models.api",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
