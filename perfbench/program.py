"""The system under test, as the benchmark drives it: ``repro_torch``'s model, batcher
and training step, given a configuration file and the benchmark's own weights."""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import model as ref


def model_config(config: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.config import ModelConfig
    moe = int(config.get("num_experts", 0)) > 0
    return ModelConfig(
        name=config["name"], family="moe" if moe else "dense",
        num_layers=int(config["num_hidden_layers"]), d_model=int(config["hidden_size"]),
        num_heads=int(config["num_attention_heads"]),
        num_kv_heads=int(config["num_key_value_heads"]), d_ff=int(config["intermediate_size"]),
        vocab_size=int(config["vocab_size"]), head_dim=int(config["head_dim"]),
        rope_theta=float(config["rope_theta"]), norm_eps=float(config["rms_norm_eps"]),
        tie_embeddings=bool(config["tie_word_embeddings"]), dtype=config["torch_dtype"],
        num_experts=int(config.get("num_experts", 0)),
        experts_per_token=int(config.get("num_experts_per_tok", 0)),
        moe_capacity_factor=float(config.get("moe_capacity_factor", 1.25)))


def build(config: dict, seed: int, device):
    """(api, params): the program's model of ``config`` on ``device`` and the weights
    drawn from ``seed`` (``reference.model.make_weights``), which must fill the
    program's parameter tree leaf for leaf."""
    from repro_torch.models.common import tree_items
    from repro_torch.models.model import build as build_model

    api = build_model(model_config(config), device=device)
    params = ref.make_weights(ref.Arch.from_config(config), seed, device)
    want = {p: (tuple(s.shape), s.dtype) for p, s in tree_items(api.abstract_params())}
    have = {"/".join(p): (tuple(t.shape), t.dtype) for p, t in ref.leaves(params)}
    if want != have:
        raise RuntimeError(f"the program's parameters {want} are not the benchmark's {have}")
    return api, params


def layer_norms(tree: Dict, fn=lambda t: t) -> Dict[str, float]:
    """Float32 norm of ``fn(leaf)`` for every leaf, a stacked block leaf layer by layer
    (``blocks/attn/wq/3``), read in one copy."""
    names, vals = [], []
    for path, t in ref.leaves(tree):
        name = "/".join(path)
        if path[0] == "blocks":
            names += [f"{name}/{i}" for i in range(t.shape[0])]
            vals += [fn(t[i]).float().norm() for i in range(t.shape[0])]
        else:
            names.append(name)
            vals.append(fn(t).float().norm())
    return dict(zip(names, torch.stack(vals).tolist()))
