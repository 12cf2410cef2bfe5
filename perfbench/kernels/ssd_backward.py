"""``ssd_backward``, the gradient of the Mamba2 chunked scan (``csrc/ssd.cu``'s
``ssd_bwd_*`` passes, four launches a call), counted at each call of the program's
``kernels/ssd.py`` ``backward`` (``plain_backward`` on the CPU).

Its cost is a frozen copy of that module's ``backward_cost``: per (head, chunk) dY·Xᵀ,
the diagonal block's dx and its shares of dc and db on the l(l+1)/2 causal pairs (2P,
2P, 2N and 2N operations a pair), and the four l·P·N products with the states; x, dy, b
and c in x's dtype, a, the final state's gradient and what the forward kernel saved
(the states entering each chunk, C·Bᵀ, the chunk decays and the final state) in float32
read once; dx, db and dc in x's dtype and da in float32 written once.

The operations are bounded at the card's peak for x's dtype (bf16 or float32),
whatever units the kernel runs them on.
"""
from perfbench.costs import Cost

SYMBOLS = ("ssd_bwd_",)
WRAP = (("repro_torch.kernels.ssd", "backward"), ("repro_torch.kernels.ssd", "plain_backward"))


def record(x, a, b, c, dy, dhf, *rest, chunk=None):
    """``backward(x, a, b, c, dy, dhf, states, cb, decay, hf, *, chunk)`` or
    ``plain_backward(x, a, b, c, dy, dhf, chunk)``; ``dhf`` None where the final state
    has no gradient."""
    bsz, s, h, p = x.shape
    chunk = rest[0] if chunk is None else chunk
    dtype = str(x.dtype).removeprefix("torch.")
    return (bsz, s, h, p, b.shape[-1], min(chunk, s), x.element_size(), dhf is not None,
            dtype), None


def cost(sizes, counts) -> Cost:
    bsz, s, h, p, n, l, esize, dhf, dtype = sizes
    nc = s // l
    flops = bsz * nc * h * (l * (l + 1.0) * (2 * p + 2 * n) + 8.0 * l * p * n)
    nbytes = ((3 * bsz * s * h * p + 4 * bsz * s * n) * esize
              + (2 * bsz * s * h + bsz * nc * h * (p * n + 1) + bsz * nc * l * l
                 + (1 + dhf) * bsz * h * p * n) * 4)
    return Cost(flops, float(nbytes), dtype)
