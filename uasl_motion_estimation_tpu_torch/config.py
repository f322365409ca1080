"""Carry a configuration of the JAX package across to the port.

The system has no weights; its state is the configuration NamedTuples.
``from_reference_config`` walks a JAX ``PipelineConfig``,
``MonoPipelineConfig``, ``CrossModalConfig``, ``SmootherConfig``,
``OdometryConfig`` or ``BAConfig`` (or any of their parts) through ``_asdict()`` and rebuilds it
from the port's NamedTuples of the same names, so both sides run the
identical configuration. It reads the tuples only and never imports jax.
"""

from __future__ import annotations

from .models.cross_modal import CrossModalConfig
from .models.frontend import KLTConfig, MatcherConfig
from .models.mono_pipeline import MonoPipelineConfig
from .models.mono_vo import MonoVOParams
from .models.odometry import OdometryConfig
from .models.pipeline import PipelineConfig
from .models.scale import ScaleConfig
from .models.smoother import SmootherConfig
from .models.stereo_vo import StereoVOParams
from .ops.geometry import Intrinsics
from .solvers.ba import BAConfig
from .solvers.lm import LMConfig

_PORT_TYPES = {t.__name__: t for t in (
    PipelineConfig, StereoVOParams, Intrinsics, MatcherConfig, KLTConfig, LMConfig,
    CrossModalConfig, MonoVOParams, MonoPipelineConfig, ScaleConfig, SmootherConfig,
    BAConfig, OdometryConfig)}


def from_reference_config(cfg):
    """Port-side copy of a JAX configuration NamedTuple (recursively);
    plain values pass through unchanged (0-d arrays as Python scalars)."""
    if hasattr(cfg, "_asdict"):
        name = type(cfg).__name__
        port_type = _PORT_TYPES.get(name)
        if port_type is None:
            raise TypeError(f"no port counterpart for configuration type {name}")
        fields = {k: from_reference_config(v) for k, v in cfg._asdict().items()}
        unknown = set(fields) - set(port_type._fields)
        if unknown:
            raise TypeError(f"{name} fields {sorted(unknown)} have no port counterpart")
        return port_type(**fields)
    if getattr(cfg, "shape", None) == ():
        return cfg.item()
    return cfg
