from npe_tpu_torch.models import ian_simple, ian_v1

REGISTRY = {
    "IAN_simple": ian_simple,
    "IANv1": ian_v1,
}
# npe_tpu's other config; the port has not reached it yet.
NOT_YET_PORTED = ("IAN",)


def get_config(name):
    """Config-as-code lookup (npe_tpu `models/__init__.py:get_config`).
    Accepts a registry name ('IAN_simple', 'IAN_simple.py', or a path ending
    in one of those), or a path to a user config module -- any .py file
    exporting the model interface (cfg, init, encode_stats, decode)."""
    import importlib.util
    import os

    base = os.path.basename(str(name))
    if base.endswith(".py"):
        base = base[:-3]
    if base in REGISTRY:
        return REGISTRY[base]
    if base in NOT_YET_PORTED:
        raise NotImplementedError(
            f"model config {base!r} is not ported to npe_tpu_torch yet; have {sorted(REGISTRY)}"
        )
    path = str(name)
    if os.path.isfile(path) and path.endswith(".py"):
        spec = importlib.util.spec_from_file_location(f"npe_tpu_torch_user_config_{base}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        missing = [a for a in ("cfg", "init", "encode_stats", "decode") if not hasattr(mod, a)]
        if missing:
            raise KeyError(f"config file {name!r} lacks required attrs {missing}")
        return mod
    raise KeyError(f"unknown model config {name!r}; have {sorted(REGISTRY)}")
