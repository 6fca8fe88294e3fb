"""Training configuration (port of ``gsplat_tpu/config.py``).

``ConfigParameters`` has the reference's fields, names, types and defaults,
so ``utils/checkpoint.py::config_hash`` gives the same value in both
packages. ``parse_config`` reads the flat ``key: value`` subset of YAML
that ``configs/*.yaml`` use (one scalar per line, ``#`` comments, blank
lines, optional quotes) without PyYAML. Each plain scalar is resolved by
YAML 1.1's implicit rules as PyYAML's ``SafeLoader`` resolves it (null,
bool, int, float, else a string; quoted scalars are strings), and then
the reference's ``_coerce`` casts it to the field's type: ``1e-3`` (a
string in YAML 1.1) becomes a float, ``30000.0`` an int, and an int given
to a ``str`` field stays an int, as in the reference.
"""

from __future__ import annotations

import dataclasses
import re
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
    # chunk_size and cameras_per_step are kept so that config_hash matches
    # the JAX package's; the kernels pick their own blocking and the port
    # trains one camera a step, so it reads neither. pair_cap (0 = sized
    # from the scene) is the trainer's first pair capacity.
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

# YAML 1.1's implicit scalar types, in the order PyYAML's Resolver tries
# them (yaml/resolver.py): bool, float, int, null; timestamps are refused.
_YAML_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
_YAML_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_YAML_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_YAML_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_YAML_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_YAML_BOOLS = {"yes": True, "no": False, "true": True, "false": False, "on": True,
               "off": False}


def _sexagesimal(parts: list, zero):
    value, base = zero, 1
    for digit in reversed(parts):
        value += digit * base
        base *= 60
    return value


def _resolve(text: str, path: Path, lineno: int) -> Any:
    """A plain scalar as PyYAML's ``SafeLoader`` constructs it."""
    if _YAML_BOOL.match(text):
        return _YAML_BOOLS[text.lower()]
    if _YAML_FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * float("inf")
        if value == ".nan":
            return float("nan")
        if ":" in value:
            return sign * _sexagesimal([float(p) for p in value.split(":")], 0.0)
        return sign * float(value)
    if _YAML_INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * _sexagesimal([int(p) for p in value.split(":")], 0)
        return sign * int(value)
    if _YAML_NULL.match(text):
        return None
    if _YAML_TIMESTAMP.match(text):
        raise ValueError(f"{path}:{lineno}: a YAML timestamp is not a config value: {text!r}")
    return text


def _scalar(text: str, path: Path, lineno: int) -> Any:
    """The value of one ``key: value`` line: a quoted scalar as its string,
    a plain one (its comment removed) resolved as YAML 1.1 resolves it."""
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
    return _resolve((text if cut == -1 else text[:cut]).strip(), path, lineno)


def _read_flat_yaml(path: Path) -> dict[str, Any]:
    """The ``key: value`` pairs of a flat YAML file, values resolved.

    Raises ``ValueError`` on anything outside that subset (indented or list
    lines, a line without ``key:``)."""
    raw: dict[str, Any] = {}
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


def _coerce(key: str, value: Any) -> Any:
    """The reference's ``_coerce``: a resolved scalar cast to the field's
    type where the reference casts it."""
    t = str(_TYPES[key])
    if t == "float" and not isinstance(value, float):
        return float(value)
    if t == "int" and not isinstance(value, int):
        return int(value)
    if t == "bool" and isinstance(value, str):
        return value.strip().lower() in ("true", "1", "yes", "on")
    return value
