"""The plain reference of the decoder-only LMs the benchmark runs, and their weights.

Everything here is written from the configuration files under ``perfbench/configs``
and the published architectures (Llama-style blocks: RMSNorm, RoPE by halves, GQA,
SwiGLU; OLMoE's top-k routed experts), in plain PyTorch. It imports nothing of the
program under test and takes nothing it made: the weights are made here from the
run's seed, and the program is handed the same tensors.

``Arch`` is a configuration file read into the sizes the reference needs.
``weight_spec`` lists every parameter in a fixed order, in the stacked layout the
program takes (``[L, ...]`` per block leaf); ``make_weights`` draws each leaf on the
device from its own generator, so ``make_leaf`` can draw any one of them again.

The forward runs in float32 one layer at a time (``torch.backends`` TF32 off, which
``no_tf32`` sets); ``quant`` names the control's lower precision (``"fp8"``: every
matrix product's operands rounded to float8 e4m3, weights by tensor, activations by
row), ``None`` is the reference itself.

This is the module a configuration file names by default (``perfbench.reference``
lists what a module gives); its model arithmetic is ``perfbench.costs``'s.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import costs

Path = Tuple[str, ...]

# the configuration keys a cell at smoke size takes, by family
SMOKE = {
    "dense": dict(num_hidden_layers=2, hidden_size=64, intermediate_size=160, num_attention_heads=8,
                  num_key_value_heads=2, head_dim=8, vocab_size=256),
    "moe": dict(num_hidden_layers=2, hidden_size=64, intermediate_size=32, num_attention_heads=4,
                num_key_value_heads=4, head_dim=16, vocab_size=256, num_experts=8,
                num_experts_per_tok=2),
}


@dataclass(frozen=True)
class Arch:
    family: str                 # "dense" or "moe"
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int                    # SwiGLU width (one expert's for moe)
    vocab: int
    rope_theta: float
    eps: float
    tied: bool
    experts: int = 0
    top_k: int = 0
    norm_topk: bool = True
    capacity_factor: float = 1.25
    group: int = 1024           # tokens routed together (capacity is per group)
    aux_weight: float = 0.0

    @staticmethod
    def from_config(c: dict) -> "Arch":
        moe = int(c.get("num_experts", 0)) > 0
        return Arch(family="moe" if moe else "dense", layers=int(c["num_hidden_layers"]),
                    d=int(c["hidden_size"]), heads=int(c["num_attention_heads"]),
                    kv_heads=int(c["num_key_value_heads"]), head_dim=int(c["head_dim"]),
                    ffn=int(c["intermediate_size"]), vocab=int(c["vocab_size"]),
                    rope_theta=float(c["rope_theta"]), eps=float(c["rms_norm_eps"]),
                    tied=bool(c["tie_word_embeddings"]), experts=int(c.get("num_experts", 0)),
                    top_k=int(c.get("num_experts_per_tok", 0)),
                    norm_topk=bool(c.get("norm_topk_prob", True)),
                    capacity_factor=float(c.get("moe_capacity_factor", 1.25)),
                    group=int(c.get("moe_group_size", 1024)),
                    aux_weight=float(c.get("router_aux_loss_coef", 0.0)))

    def capacity(self, tokens: int) -> int:
        """Assignments an expert keeps of a group of ``tokens``: ceil(factor·T·k/E),
        rounded up to a multiple of 8, at least k."""
        cap = int(math.ceil(self.capacity_factor * tokens * self.top_k / self.experts))
        return max(self.top_k, ((cap + 7) // 8) * 8)


# (path, shape, dtype, init): init "normal:<std>" or "norm" (1 + N(0, 0.1²))
def weight_spec(a: Arch) -> List[Tuple[Path, Tuple[int, ...], torch.dtype, str]]:
    L, d, dh, f = a.layers, a.d, a.head_dim, a.ffn
    bf = torch.bfloat16
    spec = [(("embed",), (a.vocab, d), bf, "normal:0.02"),
            (("blocks", "norm1"), (L, d), bf, "norm"),
            (("blocks", "attn", "wq"), (L, d, a.heads * dh), bf, f"normal:{d ** -0.5}"),
            (("blocks", "attn", "wk"), (L, d, a.kv_heads * dh), bf, f"normal:{d ** -0.5}"),
            (("blocks", "attn", "wv"), (L, d, a.kv_heads * dh), bf, f"normal:{d ** -0.5}"),
            (("blocks", "attn", "wo"), (L, a.heads * dh, d), bf, f"normal:{(a.heads * dh) ** -0.5}"),
            (("blocks", "norm2"), (L, d), bf, "norm")]
    if a.family == "moe":
        e = a.experts
        spec += [(("blocks", "moe", "router"), (L, d, e), torch.float32, f"normal:{d ** -0.5}"),
                 (("blocks", "moe", "w_gate"), (L, e, d, f), bf, f"normal:{d ** -0.5}"),
                 (("blocks", "moe", "w_up"), (L, e, d, f), bf, f"normal:{d ** -0.5}"),
                 (("blocks", "moe", "w_down"), (L, e, f, d), bf, f"normal:{f ** -0.5}")]
    else:
        spec += [(("blocks", "mlp", "w_gate"), (L, d, f), bf, f"normal:{d ** -0.5}"),
                 (("blocks", "mlp", "w_up"), (L, d, f), bf, f"normal:{d ** -0.5}"),
                 (("blocks", "mlp", "w_down"), (L, f, d), bf, f"normal:{f ** -0.5}")]
    spec.append((("final_norm",), (d,), bf, "norm"))
    if not a.tied:
        spec.append((("lm_head",), (d, a.vocab), bf, f"normal:{d ** -0.5}"))
    return spec


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` of a run seeded ``seed`` (any integer)."""
    return (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) % (2 ** 63)


def make_leaf(a: Arch, seed: int, path: Path, device) -> torch.Tensor:
    """Leaf ``path`` as ``make_weights`` draws it: one generator call, in its dtype."""
    return draw_leaf(weight_spec(a), seed, path, device)


def make_weights(a: Arch, seed: int, device) -> Dict:
    """The nested parameter tree, every leaf drawn on ``device`` from ``seed``."""
    return draw_weights(weight_spec(a), seed, device)


def draw_leaf(spec, seed: int, path: Path, device) -> torch.Tensor:
    """Leaf ``path`` of a ``weight_spec`` list, drawn from its own generator."""
    for i, (p, shape, dtype, init) in enumerate(spec):
        if p == path:
            g = torch.Generator(device=device).manual_seed(leaf_seed(seed, i))
            t = torch.randn(shape, generator=g, device=device, dtype=dtype)
            if init == "norm":
                return t.mul_(0.1).add_(1.0)
            return t.mul_(float(init.split(":")[1]))
    raise KeyError(path)


def draw_weights(spec, seed: int, device) -> Dict:
    """The nested tree of every leaf of a ``weight_spec`` list, drawn on ``device``."""
    tree: Dict = {}
    for path, *_ in spec:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = draw_leaf(spec, seed, path, device)
    return tree


def leaves(tree: Dict, prefix: Path = ()) -> Iterator[Tuple[Path, torch.Tensor]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def get(tree: Dict, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# The control's lower precision
# ---------------------------------------------------------------------------
FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """x rounded to float8 e4m3 at a scale by tensor (dim None) or along ``dim``; the
    gradient passes straight through."""
    amax = x.detach().abs().amax() if dim is None else x.detach().abs().amax(dim=dim, keepdim=True)
    s = FP8_MAX / amax.clamp(min=1e-30)
    q = (x.detach() * s).to(torch.float8_e4m3fn).float() / s
    return x + (q - x).detach()


def mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """x @ w in float32; under ``quant="fp8"`` both operands rounded first."""
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, None)
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return x @ w


# ---------------------------------------------------------------------------
# Layers, float32
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, dh] rotated by positions 0..S-1, by halves (Llama)."""
    s, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


ATTN_ROWS = 1024   # query rows of one block of scores


def _attn_rows(q, k, v, q0: int):
    """Causal softmax attention of the query rows q [B, n, Hk, G, dh] at q0.. against
    k, v [B, S, Hk, dh]."""
    n, dh = q.shape[1], q.shape[-1]
    kk, vv = k[:, :q0 + n], v[:, :q0 + n]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, kk) * dh ** -0.5
    qpos = torch.arange(q0, q0 + n, device=q.device)[:, None]
    kpos = torch.arange(q0 + n, device=q.device)[None, :]
    s = s.masked_fill(kpos > qpos, float("-inf"))
    return torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), vv)


def attention(x, lp, a: Arch, quant, grad: bool):
    """x [B, S, D] (normed) -> [B, S, D]."""
    b, s, _ = x.shape
    g = a.heads // a.kv_heads
    q = mm(x, lp["wq"].float(), quant).reshape(b, s, a.heads, a.head_dim)
    k = mm(x, lp["wk"].float(), quant).reshape(b, s, a.kv_heads, a.head_dim)
    v = mm(x, lp["wv"].float(), quant).reshape(b, s, a.kv_heads, a.head_dim)
    q = rope(q, a.rope_theta).reshape(b, s, a.kv_heads, g, a.head_dim)
    k = rope(k, a.rope_theta)
    parts = []
    for q0 in range(0, s, ATTN_ROWS):
        qb = q[:, q0:q0 + ATTN_ROWS]
        parts.append(checkpoint(_attn_rows, qb, k, v, q0, use_reentrant=False) if grad
                     else _attn_rows(qb, k, v, q0))
    o = torch.cat(parts, dim=1).reshape(b, s, a.heads * a.head_dim)
    return mm(o, lp["wo"].float(), quant)


def swiglu(x, wg, wu, wd, quant):
    return mm(F.silu(mm(x, wg.float(), quant)) * mm(x, wu.float(), quant), wd.float(), quant)


def route(x: torch.Tensor, router: torch.Tensor, a: Arch):
    """x [..., T, D] -> (expert [..., T, k], weight [..., T, k], probs [..., T, E])."""
    probs = torch.softmax(x @ router.float(), dim=-1)
    w, idx = torch.topk(probs, a.top_k, dim=-1)
    if a.norm_topk:
        w = w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return idx, w, probs


def moe(x: torch.Tensor, mp, a: Arch, quant):
    """Routing groups x [G, T, D] -> (y [G, T, D], aux [G]): each token's top-k experts,
    weighted; an expert keeps the first ``capacity`` assignments of a group in
    token-major order and drops the rest. The kept rows of every group go through
    each expert together."""
    g, t, d = x.shape
    idx, w, probs = route(x, mp["router"], a)                 # [G, T, k], [G, T, E]
    flat = idx.reshape(g, t * a.top_k)                         # assignment t*k + j
    onehot = F.one_hot(flat, a.experts)                        # [G, T*k, E]
    rank = (torch.cumsum(onehot, dim=1) - 1).gather(2, flat[..., None])[..., 0]
    keep = (rank < a.capacity(t)).reshape(-1)
    expert = flat.reshape(-1)
    kept = keep.nonzero()[:, 0]
    kept = kept[torch.argsort(expert[kept], stable=True)]      # by expert
    counts = torch.bincount(expert[kept], minlength=a.experts).tolist()
    rows = kept // a.top_k                                     # token of each, over all groups
    xs = x.reshape(g * t, d)[rows]
    outs, o = [], 0
    for e, n in enumerate(counts):
        if n:
            outs.append(swiglu(xs[o:o + n], mp["w_gate"][e], mp["w_up"][e], mp["w_down"][e], quant))
            o += n
    y = torch.zeros((g * t, d), dtype=x.dtype, device=x.device)
    if outs:
        y = y.index_add(0, rows, torch.cat(outs) * w.reshape(-1)[kept][:, None])
    density = onehot.reshape(g, t, a.top_k, a.experts).sum(dim=2).float().mean(dim=1)
    aux = a.experts * (density * probs.mean(dim=1)).sum(dim=-1)
    return y.reshape(g, t, d), aux


def ffn(x, lp, a: Arch, quant):
    """x [B, S, D] (normed) -> (y, aux of the layer, mean over its routing groups)."""
    if a.family != "moe":
        mp = lp["mlp"]
        return swiglu(x, mp["w_gate"], mp["w_up"], mp["w_down"], quant), None
    b, s, d = x.shape
    gs = min(a.group, b * s)
    y, aux = moe(x.reshape(-1, gs, d), lp["moe"], a, quant)
    return y.reshape(b, s, d), aux.mean()


def block(h, lp, a: Arch, quant, grad: bool):
    """One layer: (h, aux or a zero)."""
    h = h + attention(rms_norm(h, lp["norm1"], a.eps), lp["attn"], a, quant, grad)
    y, aux = ffn(rms_norm(h, lp["norm2"], a.eps), lp, a, quant)
    return h + y, (aux if aux is not None else h.new_zeros(()))


def layer_params(params: Dict, i: int) -> Dict:
    """Layer ``i``'s leaves: of the stacked blocks, or of a per-layer list
    (``split_layers``)."""
    blocks = params["blocks"]
    if isinstance(blocks, list):
        return blocks[i]

    def take(node):
        return {k: take(v) if isinstance(v, dict) else v[i] for k, v in node.items()}
    return take(blocks)


def split_layers(params: Dict, a: Arch, dtype=torch.float32) -> Dict:
    """The tree with ``blocks`` as a list of per-layer trees, every leaf a tensor of
    its own in ``dtype`` (leaves to differentiate: a slice of a stacked leaf would
    give each layer's gradient the whole stack's size)."""
    out = {k: v.to(dtype).clone() for k, v in params.items() if k != "blocks"}
    out["blocks"] = [
        {k: ({kk: vv[i].to(dtype).clone() for kk, vv in v.items()} if isinstance(v, dict)
             else v[i].to(dtype).clone()) for k, v in params["blocks"].items()}
        for i in range(a.layers)]
    return out


def head_weight(params: Dict, a: Arch) -> torch.Tensor:
    return params["embed"].T if a.tied else params["lm_head"]


def hidden(params: Dict, tokens: torch.Tensor, a: Arch, quant=None, grad: bool = False):
    """tokens [B, S] -> (final-normed hidden [B, S, D] float32, aux: mean over layers).
    With ``grad`` each layer is checkpointed, so a backward holds one layer's
    activations at a time."""
    h = params["embed"].float()[tokens.long()]
    aux = h.new_zeros(())
    for i in range(a.layers):
        lp = layer_params(params, i)
        if grad:
            h, la = checkpoint(block, h, lp, a, quant, grad, use_reentrant=False)
        else:
            h, la = block(h, lp, a, quant, grad)
        aux = aux + la / a.layers
    return rms_norm(h, params["final_norm"], a.eps), aux


LOSS_ROWS = 512


def _xent_sum(h, w, t, quant):
    logits = mm(h, w.float(), quant)
    return (torch.logsumexp(logits, dim=-1) - logits.gather(-1, t[..., None].long())[..., 0]).sum()


def train_loss(params: Dict, tokens: torch.Tensor, targets: torch.Tensor, a: Arch, quant=None):
    """The mean token cross-entropy plus ``aux_weight`` x the routers' aux loss."""
    h, aux = hidden(params, tokens, a, quant, grad=True)
    w = head_weight(params, a)
    total = h.new_zeros(())
    for c0 in range(0, h.shape[1], LOSS_ROWS):
        total = total + checkpoint(_xent_sum, h[:, c0:c0 + LOSS_ROWS], w,
                                   targets[:, c0:c0 + LOSS_ROWS], quant, use_reentrant=False)
    return total / targets.numel() + a.aux_weight * aux


@torch.no_grad()
def next_token_logits(params: Dict, tokens: torch.Tensor, rows: torch.Tensor, a: Arch,
                      quant=None) -> torch.Tensor:
    """tokens [S] of one sequence -> the logits [len(rows), V] at positions ``rows``."""
    h, _ = hidden(params, tokens[None], a, quant)
    return mm(h[0, rows.long()], head_weight(params, a).float(), quant)


# ---------------------------------------------------------------------------
# Model arithmetic
# ---------------------------------------------------------------------------
prefill_flops = costs.prefill_flops
decode_flops = costs.decode_flops
train_flops = costs.train_flops


def cache_bytes(config: dict, cell: dict) -> int:
    """The bytes of the slot cache (K and V, bf16, every layer) the batcher reserves."""
    return (2 * 2 * cell["slots"] * cell["cache_len"] * int(config["num_hidden_layers"])
            * int(config["num_key_value_heads"]) * int(config["head_dim"]))
