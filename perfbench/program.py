"""The system under test, as the benchmark drives it: ``repro_torch``'s model, batcher
and training step, given a configuration file and the benchmark's own weights."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from perfbench.reference import for_config

# ModelConfig field <- configuration key, read where the file has the key with a value
FIELDS = (("num_layers", "num_hidden_layers", int), ("d_model", "hidden_size", int),
          ("num_heads", "num_attention_heads", int), ("num_kv_heads", "num_key_value_heads", int),
          ("d_ff", "intermediate_size", int), ("vocab_size", "vocab_size", int),
          ("head_dim", "head_dim", int), ("rope_theta", "rope_theta", float),
          ("norm_eps", "rms_norm_eps", float), ("tie_embeddings", "tie_word_embeddings", bool),
          ("dtype", "torch_dtype", str), ("num_experts", "num_experts", int),
          ("experts_per_token", "num_experts_per_tok", int),
          ("moe_capacity_factor", "moe_capacity_factor", float))


def model_config(config: dict):
    """The program's ``ModelConfig`` of a configuration file: its keys under ``FIELDS``,
    the family ``moe`` where it has experts and ``dense`` otherwise, then the file's
    ``"program"`` block, keyword arguments of ``ModelConfig`` that override those (a
    JSON list taken as a tuple: the frozen ``ModelConfig`` holds no lists). A key of the
    block that is no field of ``ModelConfig`` fails, naming itself."""
    from repro_torch.config import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {field: conv(config[key]) for field, key, conv in FIELDS if config.get(key) is not None}
    kw.update(name=config["name"], family="moe" if kw.get("num_experts") else "dense")
    for key, value in config.get("program", {}).items():
        if key not in fields:
            raise ValueError(f"{config['name']}: the program block's key {key!r} is no field of "
                             f"repro_torch's ModelConfig")
        kw[key] = tuple(value) if isinstance(value, list) else value
    return ModelConfig(**kw)


def build(config: dict, seed: int, device):
    """(api, params): the program's model of ``config`` on ``device`` and the weights
    drawn from ``seed`` (its reference module's ``make_weights``), which must fill the
    program's parameter tree leaf for leaf."""
    from repro_torch.models.common import tree_items
    from repro_torch.models.model import build as build_model

    ref = for_config(config)
    api = build_model(model_config(config), device=device)
    params = ref.make_weights(ref.Arch.from_config(config), seed, device)
    want = {p: (tuple(s.shape), s.dtype) for p, s in tree_items(api.abstract_params())}
    have = {"/".join(p): (tuple(t.shape), t.dtype) for p, t in ref.leaves(params)}
    if want != have:
        raise RuntimeError(f"the program's parameters {want} are not the benchmark's {have}")
    return api, params


def layer_norms(ref, tree: Dict, fn=lambda t: t) -> Dict[str, float]:
    """Float32 norm of ``fn(leaf)`` for every leaf of ``tree`` (walked by the reference
    module ``ref``), a stacked block leaf layer by layer (``blocks/attn/wq/3``), read in
    one copy."""
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
