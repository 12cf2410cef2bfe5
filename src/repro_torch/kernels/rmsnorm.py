"""Row RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu``, its plain version and its gradient.

Counterpart of ``repro.kernels.rmsnorm``. ``rmsnorm`` launches the kernel on
CUDA tensors and raises on anything else; ``plain`` is the PyTorch version
the CPU path and the tests use; on a ``meta`` tensor ``rmsnorm`` returns an
empty output of the kernel's shape (the dry-run), and ``cost`` is the work of
one call. ``RMSNormFunction`` is the kernel under
autograd: its forward is ``rmsnorm`` (``plain`` on a CPU tensor), its backward is
``backward``, the backward kernel of the same source (``plain_backward``, the
gradient formula in torch ops, on a CPU tensor; the reference has no backward
kernel: XLA differentiates its jnp norm). ``backward_plan`` is the backward kernel's
partition of a call (the threads a row, the rows a block, the blocks), a function of the
shape; ``chunked_backward_reference`` is the kernel's two passes in
float32 PyTorch under that partition, for the tests.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models.layers import rms_norm as plain

__all__ = ["rmsnorm", "plain", "cost", "plain_backward", "chunked_backward_reference",
           "backward_blocks", "backward_plan", "BackwardPlan", "backward", "backward_cost",
           "RMSNormFunction", "launches", "backward_launches", "BACKWARD_BLOCKS"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)
backward_launches = 0  # backward kernel launches since the last reset

_ENTRY = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_BACKWARD_ENTRY = {torch.float32: "rmsnorm_backward_f32", torch.bfloat16: "rmsnorm_backward_bf16"}
# The backward's rows pass runs at most BACKWARD_BLOCKS blocks (two an H100 SM) where a thread
# holds at most HELD elements of a row (ptxas: ~126 registers in bf16, so two blocks of 256
# threads fit an SM), else half as many (one an SM; up to MAX_HELD elements a thread, 255
# registers without a spill); each block takes a contiguous run of rows, in steps of one row
# a team. Its float32 workspace holds a row of column sums a block, which the second pass
# adds SCALE_WARPS warps a column (csrc/rmsnorm.cu).
BACKWARD_BLOCKS = 264
HELD, MAX_HELD = 16, 48
BACKWARD_THREADS = 256          # a block's threads at most (kBwdMaxThreads)
SCALE_WARPS = 16                # kScaleWarps
# the units (16 bytes of a row, or one element where rows are not 16-byte aligned) a thread
# may hold of a row, as the source instantiates them
VECTORS = {True: (2, 3, 4, 5, 6, 8), False: (4, 8, 16)}
SMEM_BYTES = 227 * 1024 - 1024  # dynamic shared memory a block may use (the teams' column sums)


class BackwardPlan(NamedTuple):
    """The backward kernel's partition of a call: ``unit`` elements a load (16 bytes, or 1
    where rows are not 16-byte aligned), ``vectors`` units a thread holds of a row, ``team``
    threads a row (a multiple of 8), ``teams`` rows a step of a block (its threads whole
    groups of 8, at most ``BACKWARD_THREADS``, not always whole warps), ``rows_per_block``
    contiguous rows a block and ``blocks`` blocks (the workspace's rows)."""
    unit: int
    vectors: int
    team: int
    teams: int
    rows_per_block: int
    blocks: int


def cost(x: torch.Tensor, scale: torch.Tensor) -> _build.Cost:
    """x and the output read and written once, the scale once; 4 operations an element."""
    numel = x.numel()
    return _build.Cost(4.0 * numel, float((2 * numel + scale.numel()) * x.element_size()))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x [..., D], scale [D] of x's dtype -> [..., D] in x's dtype."""
    global launches
    if x.device.type == "meta":
        return torch.empty_like(x)
    _build.check_inputs("rmsnorm", x.device, x=x, scale=scale)
    _build.require(x.dtype in _ENTRY, f"rmsnorm: dtype {x.dtype} not supported")
    _build.require(scale.dtype == x.dtype, "rmsnorm: scale must have x's dtype")
    d = x.shape[-1]
    _build.require(tuple(scale.shape) == (d,), f"rmsnorm: scale shape {tuple(scale.shape)} != ({d},)")
    rows = x.numel() // d if d else 0
    _build.require(rows < 2**31, "rmsnorm: too many rows")
    out = torch.empty_like(x)
    fn = getattr(_build.library("rmsnorm"), _ENTRY[x.dtype])
    _build.check(fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
                    _build.stream(x.device)), "rmsnorm")
    launches += 1
    return out


def plain_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``plain(x, scale, eps)`` for the output gradient ``g``:
    (dx in x's dtype, dscale in scale's dtype), statistics in float32.

    With r = rsqrt(mean(x²) + eps), x̂ = x·r and gs = g·scale:
    dx = r·(gs − x̂·mean(gs·x̂)) over the row, dscale = Σ_rows g·x̂.
    """
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    gf = g.float()
    gs = gf * scale.float()
    dx = rstd * (gs - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    dscale = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def backward_blocks(rows: int, d: int, element_size: int) -> int:
    """The rows pass's blocks for ``rows`` rows of ``d`` elements of ``element_size`` bytes
    (the workspace's rows), each over a run of contiguous rows, the last perhaps fewer: a
    function of the shape alone, so the sums repeat on any card."""
    return backward_plan(rows, d, element_size).blocks


def _teams(team: int) -> int:
    """The most teams of ``team`` threads a block holds (0 if none fits)."""
    return BACKWARD_THREADS // max(team, 1)


def _split(n: int, per_unit: int):
    """(units a thread, threads a row) for a row of ``n`` units of ``per_unit`` elements
    (16 bytes, or 1 where rows are not 16-byte aligned): of the splits into a team
    of whole groups of 8 threads that hold at most ``MAX_HELD`` elements a thread, one with
    the most threads a block; among those, the fewest units that hold at most ``HELD``
    elements (two blocks an SM), else the most units (one block an SM: the more a thread
    holds, the more bytes are in flight). Else (no such split) the first of ``VECTORS``
    whose team, rounded up, fits a block, its last threads holding fewer units."""
    vec = per_unit > 1
    exact = [(v, n // v) for v in VECTORS[vec] if n >= v and n % v == 0 and (n // v) % 8 == 0
             and _teams(n // v) and v * per_unit <= MAX_HELD]
    if exact:
        small = lambda v: v * per_unit <= HELD
        return min(exact, key=lambda c: (-c[1] * _teams(c[1]), not small(c[0]),
                                         c[0] if small(c[0]) else -c[0]))
    for v in VECTORS[vec]:
        team = -(-max(8, -(-n // v)) // 8) * 8
        if team <= BACKWARD_THREADS:
            return v, team
    return None


def backward_plan(rows: int, d: int, element_size: int, aligned: bool = True) -> BackwardPlan:
    """The backward kernel's partition of ``rows`` rows of ``d`` elements of
    ``element_size`` bytes. A row is ``d / unit`` units, split among a team of threads by
    ``_split``: at every training width (768, 1536, 1600, 2048, 3200, 4096) every thread holds
    as many units as the others and none idles. The blocks and their runs of rows follow from
    the shape alone (the split of 16-byte units): ``BACKWARD_BLOCKS`` at most where a thread
    holds at most ``HELD`` elements, half as many where it holds more. Rows that are not
    16-byte aligned (``aligned`` False) take single elements, in teams of their own."""
    unit = 16 // element_size if (d * element_size) % 16 == 0 else 1
    split = _split(d // unit, unit)
    _build.require(split is not None, f"rmsnorm backward: rows of {d} elements are too wide")
    per = max(1, -(-rows // (BACKWARD_BLOCKS if split[0] * unit <= HELD else BACKWARD_BLOCKS // 2)))
    if unit > 1 and not aligned:
        unit, split = 1, _split(d, 1)
        _build.require(split is not None, f"rmsnorm backward: rows of {d} elements are too wide")
    vectors, team = split
    teams = _teams(team)
    _build.require(4 * teams * d <= SMEM_BYTES, f"rmsnorm backward: rows of {d} elements are too wide")
    return BackwardPlan(unit, vectors, team, teams, per, -(-rows // per) if rows > 0 else 0)


def chunked_backward_reference(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                               eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's two passes in float32 PyTorch under ``backward_plan``: (1) each
    row's Σx² and Σ gs·x in one reduction, dx = r·(gs − x̂·r·Σ gs·x / D); each team of a
    block adds g·x̂ of its rows (step k's row k·teams + team of the block's run) in step
    order, and the teams' sums are added in team order into the block's row of a
    [blocks, D] workspace; (2) dscale, the workspace's rows added ``SCALE_WARPS`` at a time:
    warp w the rows w, w + SCALE_WARPS, ... in order, then the warps in order."""
    d = x.shape[-1]
    xf, gf = x.reshape(-1, d).float(), g.reshape(-1, d).float()
    rows = xf.shape[0]
    sf = scale.float()
    r = torch.rsqrt(xf.square().sum(-1, keepdim=True) / d + eps)
    mean = r * (gf * sf * xf).sum(-1, keepdim=True) / d
    xhat = xf * r
    dx = r * (gf * sf - xhat * mean)
    plan = backward_plan(rows, d, x.element_size())
    per, blocks, teams = plan.rows_per_block, max(plan.blocks, 1), plan.teams
    steps = -(-per // teams)
    contrib = torch.cat([gf * xhat, xf.new_zeros((blocks * per - rows, d))])
    contrib = contrib.reshape(blocks, per, d)
    contrib = torch.cat([contrib, contrib.new_zeros((blocks, steps * teams - per, d))], dim=1)
    contrib = contrib.reshape(blocks, steps, teams, d)
    team_sums = torch.zeros((blocks, teams, d), device=x.device)
    for k in range(steps):
        team_sums = team_sums + contrib[:, k]
    partial = torch.zeros((blocks, d), device=x.device)
    for t in range(teams):
        partial = partial + team_sums[:, t]
    pad = (-blocks) % SCALE_WARPS
    partial = torch.cat([partial, partial.new_zeros((pad, d))]).reshape(-1, SCALE_WARPS, d)
    warps = torch.zeros((SCALE_WARPS, d), device=x.device)
    for rows_of_warps in partial:
        warps = warps + rows_of_warps
    dscale = torch.zeros(d, device=x.device)
    for w in warps:
        dscale = dscale + w
    return dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype)


def backward_cost(x: torch.Tensor, scale: torch.Tensor) -> _build.Cost:
    """8 operations an element (Σx², Σ gs·x, dx, g·x̂); x, g and dx once, scale read and
    dscale written once."""
    numel = x.numel()
    return _build.Cost(8.0 * numel, float((3 * numel + 2 * scale.numel()) * x.element_size()))


def backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
             eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: x [..., D], scale [D], g of x's shape, all of x's dtype ->
    (dx, dscale), by ``backward_plan`` (16-byte units where x, scale and g are aligned)."""
    global backward_launches
    if x.device.type == "meta":
        return torch.empty_like(x), torch.empty_like(scale)
    what = "rmsnorm backward"
    _build.check_inputs(what, x.device, x=x, scale=scale, g=g)
    _build.require(x.dtype in _BACKWARD_ENTRY and scale.dtype == x.dtype and g.dtype == x.dtype,
                   f"{what}: x, scale and g must share a dtype of {list(_BACKWARD_ENTRY)}")
    d = x.shape[-1]
    _build.require(tuple(scale.shape) == (d,) and g.shape == x.shape,
                   f"{what}: scale [D] and g of x's shape")
    rows = x.numel() // d if d else 0
    _build.require(rows < 2**31, f"{what}: too many rows")
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, g))
    plan = backward_plan(rows, d, x.element_size(), aligned)
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    partial = torch.empty((max(plan.blocks, 1), d), dtype=torch.float32, device=x.device)
    fn = getattr(_build.library("rmsnorm"), _BACKWARD_ENTRY[x.dtype])
    _build.check(fn(x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                    partial.data_ptr(), rows, d, *plan, float(eps), _build.stream(x.device)),
                 what)
    backward_launches += 1
    return dx, dscale


class RMSNormFunction(torch.autograd.Function):
    """``rmsnorm`` (the kernel; ``plain`` on the CPU) forward, ``backward`` (the kernel;
    ``plain_backward`` on the CPU) backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return plain(x, scale, eps) if x.device.type == "cpu" else rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        g = g.contiguous()
        with _build.kernel_scope("rmsnorm_backward", lambda: backward_cost(x, scale)):
            run = plain_backward if x.device.type == "cpu" else backward
            dx, dscale = run(x, scale, g, ctx.eps)
        return dx, dscale, None
