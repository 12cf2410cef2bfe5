"""Typed platform configuration: one validated front door for the knobs
that used to live in scattered environment variables.

``PlatformConfig`` is the single place the execution-environment toggles
live — cross-node scheduling, loop sharding, P2P artifact prefetch, and
burst prediction::

    cfg = sdk.PlatformConfig(
        crossnode=True,
        shards=True,
        prefetch=core.PrefetchConfig(hot_k=8),
        predictor=core.PredictorConfig(lead_s=1.0),
    )
    platform = sdk.Platform(elastic=sdk.Elastic(...), config=cfg)

``PlatformConfig.from_env()`` is the one validated parser for the
environment spelling; ``Platform`` calls it when no ``config=`` is
passed, so existing env-driven drivers keep working unchanged. The
legacy variables (``CROSSNODE``, ``CROSSNODE_SPREAD``,
``DANDELION_SHARDS``, ``DANDELION_SHARD_LOOKAHEAD_S``) are **deprecated
aliases**: setting any of them emits one ``DeprecationWarning`` per
process (from the ``Platform`` path), and tests pin that the alias and
the explicit config build identical platforms. The new ``prefetch=`` /
``predictor=`` surface ships only through this object — there is no
``Platform(prefetch=...)`` kwarg.

Env spelling parsed by ``from_env`` (booleans are ``"0"``/``"1"``):

======================================  =====================================
variable                                field
======================================  =====================================
``CROSSNODE``                           ``crossnode`` (deprecated alias)
``CROSSNODE_SPREAD``                    ``crossnode_spread`` (deprecated)
``DANDELION_SHARDS``                    ``shards`` (deprecated alias)
``DANDELION_SHARD_LOOKAHEAD_S``         ``shard_lookahead_s`` (deprecated)
``DANDELION_PREFETCH``                  ``prefetch`` (default PrefetchConfig)
``DANDELION_PREFETCH_HOT_K``            ``prefetch.hot_k``
``DANDELION_PREFETCH_FANOUT``           ``prefetch.fanout``
``DANDELION_PREFETCH_PEER``             ``prefetch.peer``
``DANDELION_PREDICT``                   ``predictor`` (default PredictorConfig)
``DANDELION_PREDICT_BIN_S``             ``predictor.bin_s``
``DANDELION_PREDICT_LEAD_S``            ``predictor.lead_s``
``DANDELION_PREDICT_NODES_AHEAD``       ``predictor.nodes_ahead``
``DANDELION_VERIFY``                    ``verify`` ("off" | "warn" | "strict")
======================================  =====================================

Determinism contract: an all-default ``PlatformConfig`` (every field
None/0.0) builds byte-identically to the legacy env-free path, and a
``from_env`` config reproduces exactly what the scattered env reads did
— fig10–13 outputs do not move (tools/check_bench_identity.py).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Mapping, Optional

from repro_torch.core.artifacts import PrefetchConfig
from repro_torch.core.control_plane import PredictorConfig
from repro_torch.core.sim import EventLoop, ShardedEventLoop
from repro_torch.sdk.errors import DeploymentError

#: legacy environment variables PlatformConfig supersedes
DEPRECATED_ENV_ALIASES = (
    "CROSSNODE",
    "CROSSNODE_SPREAD",
    "DANDELION_SHARDS",
    "DANDELION_SHARD_LOOKAHEAD_S",
)

_warned_deprecated = False


def _parse_bool(env: Mapping[str, str], var: str) -> Optional[bool]:
    raw = env.get(var)
    if raw is None or raw == "":
        return None
    if raw == "1":
        return True
    if raw == "0":
        return False
    raise DeploymentError(f"{var} must be '0' or '1', got {raw!r}")


def _parse_float(env: Mapping[str, str], var: str) -> Optional[float]:
    raw = env.get(var)
    if raw is None or raw == "":
        return None
    try:
        return float(raw)
    except ValueError:
        raise DeploymentError(f"{var} must be a number, got {raw!r}") from None


def _parse_int(env: Mapping[str, str], var: str) -> Optional[int]:
    raw = env.get(var)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        raise DeploymentError(
            f"{var} must be an integer, got {raw!r}"
        ) from None


@dataclass(frozen=True)
class PlatformConfig:
    """Validated execution-environment configuration for ``Platform``.

    ``None`` means "platform default" everywhere — an all-default config
    is indistinguishable from passing no config at all.
    """

    # cross-node vertex scheduling (cluster shapes)
    crossnode: Optional[bool] = None
    crossnode_spread: Optional[bool] = None
    # node-sharded event loop; lookahead > 0 opts into the conservative
    # window (sound only when cross-node latencies cover it)
    shards: Optional[bool] = None
    shard_lookahead_s: float = 0.0
    # P2P artifact distribution on node join (core.artifacts) — needs a
    # cluster shape
    prefetch: Optional[PrefetchConfig] = None
    # trace-driven burst prediction (core.control_plane.BurstPredictor)
    # — needs the elastic shape
    predictor: Optional[PredictorConfig] = None
    # deploy-time purity verification gate (repro_torch.analysis): None means
    # the platform default ("warn")
    verify: Optional[str] = None

    def __post_init__(self):
        if self.verify not in (None, "off", "warn", "strict"):
            raise DeploymentError(
                f"verify must be one of 'off', 'warn', 'strict', "
                f"got {self.verify!r}"
            )
        if self.shard_lookahead_s < 0.0:
            raise DeploymentError(
                f"shard_lookahead_s must be >= 0, got {self.shard_lookahead_s}"
            )
        if self.shard_lookahead_s > 0.0 and self.shards is not True:
            raise DeploymentError(
                "shard_lookahead_s needs shards=True (the plain EventLoop "
                "has no shard windows)"
            )
        if self.crossnode_spread and self.crossnode is False:
            raise DeploymentError(
                "crossnode_spread=True contradicts crossnode=False"
            )
        if self.prefetch is not None and \
                not isinstance(self.prefetch, PrefetchConfig):
            raise DeploymentError(
                f"prefetch= takes a core.PrefetchConfig, "
                f"got {type(self.prefetch).__name__}"
            )
        if self.predictor is not None and \
                not isinstance(self.predictor, PredictorConfig):
            raise DeploymentError(
                f"predictor= takes a core.PredictorConfig, "
                f"got {type(self.predictor).__name__}"
            )

    # ------------------------------------------------------------- env
    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None, *,
                 warn_deprecated: bool = False) -> "PlatformConfig":
        """Parse the environment spelling (module docstring table) into a
        validated config. Invalid values raise ``DeploymentError``
        instead of being silently coerced to off, which is what the
        scattered ``os.environ.get(...) == "1"`` reads did.

        ``warn_deprecated=True`` (the ``Platform`` default path) emits
        one ``DeprecationWarning`` per process when any legacy alias is
        set."""
        if env is None:
            import os
            env = os.environ
        if warn_deprecated:
            _warn_if_deprecated(env)

        shards = _parse_bool(env, "DANDELION_SHARDS")
        lookahead = _parse_float(env, "DANDELION_SHARD_LOOKAHEAD_S")
        if lookahead is not None and not shards:
            lookahead = None    # legacy reads ignored it without shards

        prefetch = None
        if _parse_bool(env, "DANDELION_PREFETCH"):
            kw = {}
            hot_k = _parse_int(env, "DANDELION_PREFETCH_HOT_K")
            fanout = _parse_int(env, "DANDELION_PREFETCH_FANOUT")
            peer = _parse_bool(env, "DANDELION_PREFETCH_PEER")
            if hot_k is not None:
                kw["hot_k"] = hot_k
            if fanout is not None:
                kw["fanout"] = fanout
            if peer is not None:
                kw["peer"] = peer
            try:
                prefetch = PrefetchConfig(**kw)
            except ValueError as e:
                raise DeploymentError(str(e)) from None

        predictor = None
        if _parse_bool(env, "DANDELION_PREDICT"):
            kw = {}
            bin_s = _parse_float(env, "DANDELION_PREDICT_BIN_S")
            lead_s = _parse_float(env, "DANDELION_PREDICT_LEAD_S")
            ahead = _parse_int(env, "DANDELION_PREDICT_NODES_AHEAD")
            if bin_s is not None:
                kw["bin_s"] = bin_s
            if lead_s is not None:
                kw["lead_s"] = lead_s
            if ahead is not None:
                kw["nodes_ahead"] = ahead
            try:
                predictor = PredictorConfig(**kw)
            except ValueError as e:
                raise DeploymentError(str(e)) from None

        verify = env.get("DANDELION_VERIFY") or None
        if verify not in (None, "off", "warn", "strict"):
            raise DeploymentError(
                f"DANDELION_VERIFY must be 'off', 'warn' or 'strict', "
                f"got {verify!r}"
            )

        return cls(
            crossnode=_parse_bool(env, "CROSSNODE"),
            crossnode_spread=_parse_bool(env, "CROSSNODE_SPREAD"),
            shards=shards,
            shard_lookahead_s=lookahead or 0.0,
            prefetch=prefetch,
            predictor=predictor,
            verify=verify,
        )

    # ------------------------------------------------------------ build
    def build_loop(self) -> EventLoop:
        """The event loop this config asks for: the node-sharded loop
        when ``shards=True`` (exact mode unless ``shard_lookahead_s``
        opts into the conservative window), else the plain
        ``EventLoop`` — exactly the legacy ``DANDELION_SHARDS``
        behavior."""
        if self.shards:
            return ShardedEventLoop(lookahead_s=self.shard_lookahead_s)
        return EventLoop()

    def with_overrides(self, *, crossnode=None, crossnode_spread=None,
                       verify=None) -> "PlatformConfig":
        """This config with explicit ``Platform`` kwargs layered on top
        (an explicit kwarg always beats the config/env value)."""
        out = self
        if crossnode is not None:
            out = replace(out, crossnode=crossnode)
        if crossnode_spread is not None:
            out = replace(out, crossnode_spread=crossnode_spread)
        if verify is not None:
            out = replace(out, verify=verify)
        return out


def _warn_if_deprecated(env: Mapping[str, str]) -> None:
    global _warned_deprecated
    if _warned_deprecated:
        return
    legacy = [v for v in DEPRECATED_ENV_ALIASES if env.get(v)]
    if legacy:
        _warned_deprecated = True
        warnings.warn(
            f"environment variables {', '.join(legacy)} are deprecated "
            f"aliases; pass sdk.PlatformConfig(...) to Platform(config=...) "
            f"instead",
            DeprecationWarning,
            stacklevel=3,
        )
