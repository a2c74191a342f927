"""YAML config loading with the reference's schema.

Port of ``glearning_benchmark_tpu/utils/config.py`` (copied). PyYAML is
imported inside ``load_config`` only: a caller that builds its config as a
dict needs no YAML package.

The reference uses per-trainer ``yaml.safe_load`` with sections
``dataset|data`` / ``model`` / ``train`` / ``output`` / ``wandb``
(reference: trainer/train_ibtt.py:175-179, configs/*.yaml). We keep the same
YAML surface so reference configs drop in, but load through one code path.
"""

from __future__ import annotations


def load_config(path: str) -> dict:
    import yaml

    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"Config {path} did not parse to a mapping")
    return cfg


def deep_get(cfg: dict, *keys, default=None):
    cur = cfg
    for k in keys:
        if not isinstance(cur, dict) or k not in cur:
            return default
        cur = cur[k]
    return cur


def normalize_config(cfg: dict) -> dict:
    """Normalize the two reference schemas (GPS uses ``data``/flat keys,
    the other trainers use ``dataset``/``train``/``output``) into the
    ``dataset``/``model``/``train``/``output``/``wandb`` shape."""
    out = dict(cfg)
    if "dataset" not in out and "data" in out:
        out["dataset"] = dict(out["data"])
    out.setdefault("model", {})
    out.setdefault("train", {})
    out.setdefault("output", {})
    out.setdefault("wandb", {"use": False})
    # GPS-style flat keys
    if "out_dir" in cfg:
        out["output"].setdefault("out_dir", cfg["out_dir"])
    if "run_name" in cfg:
        out["output"].setdefault("run_name", cfg["run_name"])
    if "seed" in cfg:
        out["train"].setdefault("seed", cfg["seed"])
    if "optim" in cfg:
        optim = cfg["optim"]
        out["train"].setdefault("lr", float(optim.get("base_lr", 1e-3)))
        out["train"].setdefault("weight_decay", float(optim.get("weight_decay", 0.0)))
        out["train"].setdefault("epochs", int(optim.get("max_epoch", 100)))
        out["train"].setdefault("scheduler", optim.get("scheduler", "none"))
        out["train"].setdefault("num_warmup_epochs", int(optim.get("num_warmup_epochs", 0)))
    return out
