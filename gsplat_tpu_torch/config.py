"""Training configuration (port of ``gsplat_tpu/config.py``).

``ConfigParameters`` has the reference's fields, names, types and defaults,
so ``utils/checkpoint.py::config_hash`` gives the same value in both
packages. ``parse_config`` reads the flat ``key: value`` subset of YAML
that ``configs/*.yaml`` use (one scalar per line, ``#`` comments, blank
lines, optional quotes) without PyYAML, and applies the reference's
coercions: ``1e-3`` is a float, ``true``/``yes``/``on``/``1`` are True.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any


@dataclasses.dataclass
class ConfigParameters:
    # File paths and directories
    dataset_path: str
    output_dir: str

    # General settings
    downsample_factor: int
    print_interval: int
    num_iters: int
    ssim_frac: float
    test_eval_interval: int
    test_split_ratio: int

    # Initial Gaussian properties
    initial_opacity: float
    initial_scale_num_neighbors: int
    initial_scale_factor: float
    max_initial_scale: float

    # Rendering thresholds
    near_thresh: float
    mh_dist: float
    cull_mask_padding: int

    # Learning rates
    base_lr: float
    xyz_lr_multiplier_init: float
    xyz_lr_multiplier_final: float
    quat_lr_multiplier: float
    scale_lr_multiplier: float
    opacity_lr_multiplier: float
    rgb_lr_multiplier: float
    sh_lr_multiplier: float

    # Background settings
    use_background: bool
    use_background_end: int

    # Opacity reset settings
    reset_opacity_interval: int
    reset_opacity_value: float
    reset_opacity_start: int
    reset_opacity_end: int

    # Spherical Harmonics settings
    use_sh_precompute: bool
    max_sh_band: int
    add_sh_band_interval: int

    # Densification control
    use_split: bool
    use_clone: bool
    use_delete: bool
    adaptive_control_start: int
    adaptive_control_end: int
    adaptive_control_interval: int
    max_gaussians: int
    delete_opacity_threshold: float
    uv_grad_threshold: float
    split_scale_factor: float

    # Extensions of the reference schema, all optional. strict_reference
    # True keeps the reference binary's schedule and its dead fields dead.
    strict_reference: bool = True
    tile_size: int = 16
    # The next three are kept so that config_hash matches the JAX
    # package's; the port sizes its pair stream exactly and trains one
    # camera a step, so it reads none of them.
    chunk_size: int = 128
    pair_cap: int = 0
    cameras_per_step: int = 1
    seed: int = 0  # image sampling and split noise

    def __post_init__(self) -> None:
        if self.tile_size % 4 != 0:
            raise ValueError("tile_size must be a multiple of 4")


_REQUIRED_KEYS = [
    f.name
    for f in dataclasses.fields(ConfigParameters)
    if f.default is dataclasses.MISSING
]

_TYPES = {f.name: f.type for f in dataclasses.fields(ConfigParameters)}

_TRUE = ("true", "1", "yes", "on")


def _scalar(text: str, path: Path, lineno: int) -> str:
    """The scalar of one ``key: value`` line, quotes and comment removed."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        q = text[0]
        end = text.find(q, 1)
        while q == "'" and end != -1 and text[end + 1:end + 2] == "'":
            end = text.find(q, end + 2)  # '' is a quote inside '...'
        if end == -1:
            raise ValueError(f"{path}:{lineno}: unterminated quote")
        return text[1:end].replace("''", "'") if q == "'" else text[1:end]
    cut = text.find(" #")
    return (text if cut == -1 else text[:cut]).strip()


def _read_flat_yaml(path: Path) -> dict[str, str]:
    """The ``key: value`` pairs of a flat YAML file, values as strings.

    Raises ``ValueError`` on anything outside that subset (indented or list
    lines, a line without ``key:``)."""
    raw: dict[str, str] = {}
    for lineno, line in enumerate(path.read_text().splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#") or stripped == "---":
            continue
        key, sep, value = line.partition(":")
        if not sep or line[:1].isspace() or stripped.startswith("- ") or not key.strip():
            raise ValueError(f"{path}:{lineno}: not a flat 'key: value' line: {line!r}")
        raw[key.strip()] = _scalar(value, path, lineno)
    return raw


def parse_config(filename: str | Path) -> ConfigParameters:
    """Parse a flat YAML config; every reference key is required.

    Raises ``FileNotFoundError`` on a missing file and ``KeyError`` naming the
    first missing required key, as the reference does.
    """
    path = Path(filename)
    if not path.is_file():
        raise FileNotFoundError(f"Config file not found: {path}")
    raw = _read_flat_yaml(path)
    for key in _REQUIRED_KEYS:
        if key not in raw:
            raise KeyError(f"Missing required parameter in YAML file: {key}")
    kwargs = {key: _coerce(key, value) for key, value in raw.items() if key in _TYPES}
    return ConfigParameters(**kwargs)


def _coerce(key: str, value: str) -> Any:
    t = str(_TYPES[key])
    if t == "float":
        return float(value)
    if t == "int":
        return int(value)
    if t == "bool":
        return value.strip().lower() in _TRUE
    return value
