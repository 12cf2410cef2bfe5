"""``ssd``, the Mamba2 chunked scan (``csrc/ssd.cu``: a chunk pass, a state pass and an
output pass, three launches a call), counted at each call of ``ops.ssd``.

Its cost is a frozen copy of the program's ``kernels/ssd.py`` ``cost``: C·Bᵀ once a
chunk (shared by the heads), then per (head, chunk) the three l·P-sized products
(L ⊙ C·Bᵀ)·X, C·hᵀ and Xᵀ·B, the two l x l products on the l(l+1)/2 causal pairs only;
x, y, b and c in x's dtype and a and the final state in float32 read or written once.
The operations are bounded at the card's peak for x's dtype (bf16 or float32), whatever
units the kernel runs them on.
"""
from perfbench.costs import Cost

SYMBOLS = ("ssd_chunk_kernel", "ssd_state_kernel", "ssd_out_kernel")
WRAP = (("repro_torch.kernels.ops", "ssd"),)


def record(x, a, b, c, *, chunk):
    """x [B, S, H, P], a [B, S, H], b and c [B, S, N]; the chunk length min(chunk, S)."""
    bsz, s, h, p = x.shape
    dtype = str(x.dtype).removeprefix("torch.")
    return (bsz, s, h, p, b.shape[-1], min(chunk, s), x.element_size(), dtype), None


def cost(sizes, counts) -> Cost:
    bsz, s, h, p, n, l, esize, dtype = sizes
    nc = s // l
    flops = bsz * nc * (l * (l + 1.0) * n + h * (l * (l + 1.0) * p + 4.0 * l * p * n))
    nbytes = (2 * bsz * s * h * p + 2 * bsz * s * n) * esize + (bsz * s * h + bsz * h * p * n) * 4
    return Cost(flops, float(nbytes), dtype)
