"""Model construction from a config and a dataset bundle.

Port of ``glearning_benchmark_tpu/train/trainer.py``: ``build_model`` for
the token models (``ibtt``, ``agtt``). The training loop, and the
graph-native models (``mpnn``, ``ggps``), are later slices of the port
(ROADMAP queue A, items 4 and 5).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.transformer import SimpleTransformer
from ..tokenization.vocab import SPECIAL
from .datasets import QUERY_OFFSETS, QUERY_TASKS, DatasetBundle


def build_model(model_name: str, config: dict, bundle: DatasetBundle,
                generator: Optional[torch.Generator] = None) -> SimpleTransformer:
    """Build the model a checkpoint of ``model_name`` was trained as, with
    the JAX package's config defaults. ``generator`` seeds the initial
    parameters. ``model.remat`` and ``model.use_flash`` are accepted and
    ignored: remat has no meaning at inference, and attention always runs
    through the flash-attention kernel (its plain version on the CPU)."""
    model_cfg = config.get("model", {})
    task = bundle.task
    if model_name not in ("ibtt", "agtt"):
        if model_name in ("mpnn", "ggps"):
            raise NotImplementedError(
                f"{model_name} is not ported yet (ROADMAP queue A, item 5: "
                "models/mpnn.py and models/gps.py)")
        raise ValueError(f"unknown model {model_name!r}")
    if int(model_cfg.get("moe_experts", 0)) > 0:
        raise NotImplementedError("the Switch MoE FFN is not ported yet "
                                  "(ROADMAP queue A, item 8: models/moe.py)")
    if model_name == "ibtt":
        # from the dataset's vocab: the fixed ZINC vocab pins '<bos>' at 0,
        # the synthetic SPECIAL table at 1
        bos_id = (bundle.vocab or {}).get("<bos>", SPECIAL.index("<bos>"))
        offsets = QUERY_OFFSETS.get(task, (1, 2))
    else:
        bos_id = bundle.meta.get("bos_id", 0)
        offsets = (1, 2)  # trail-appended '<q> u v'
    seq_len = bundle.meta.get("max_len", 0)
    return SimpleTransformer(
        vocab_size=bundle.vocab_size,
        d_model=int(model_cfg.get("d_model", 32)),
        nhead=int(model_cfg.get("nhead", 4)),
        nlayers=int(model_cfg.get("nlayers", 4)),
        d_ff=int(model_cfg.get("d_ff", 128)),
        p_drop=float(model_cfg.get("dropout", 0.1)),
        max_pos=max(int(model_cfg.get("max_pos", 600)), seq_len),
        num_classes=bundle.num_classes,
        use_query_nodes=task in QUERY_TASKS,
        task=task,
        bos_id=bos_id,
        query_offsets=offsets,
        compute_dtype=model_cfg.get("compute_dtype", "bfloat16"),
        generator=generator,
    )
