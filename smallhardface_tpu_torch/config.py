"""Global config tree with TOML schema-merge semantics.

The port's own copy of ``smallhardface_tpu/config.py``, with its own ``cfg``
object: setting a key here does not change the JAX package's config, nor
the other way round. One schema serves both packages: the TOML files under
``smallhardface_tpu/configs/`` are read here as data (``default.toml`` is
the schema, and ``--conf`` files work for either package); nothing of that
package is imported. The port's own keys (``configs/port.toml``:
``MODEL.ARCH``) are added to that schema here; the JAX package does not
know them. As in the reference config system (get_config.py),
file merges (`cfg_from_file`) and dotted CLI amends (`cfg_from_list`) must
name existing keys with matching types. Output-dir layout follows
`get_output_dir` (get_config.py:48-65).
"""

from __future__ import annotations

import os
import os.path as osp
import tomllib
from ast import literal_eval

from smallhardface_tpu_torch.utils.attrdict import AttrDict
from smallhardface_tpu_torch.utils import tomlout

_PKG_DIR = osp.dirname(osp.abspath(__file__))
# the TOML schema and configs, shared with the JAX package as data files
CONFIG_DIR = osp.join(_PKG_DIR, "..", "smallhardface_tpu", "configs")
_DEFAULT_CFG_PATH = osp.join(CONFIG_DIR, "default.toml")
# the keys only the port reads (MODEL.ARCH), added to the shared schema
PORT_CONFIG_DIR = osp.join(_PKG_DIR, "configs")
_PORT_CFG_PATH = osp.join(PORT_CONFIG_DIR, "port.toml")


def _add_keys(a, b, path=""):
    """Add the keys of dict a to dict b, which may not hold them yet."""
    for k, v in a.items():
        if isinstance(v, dict) and isinstance(b.get(k), dict):
            _add_keys(v, b[k], path=f"{path}{k}.")
        elif k in b:
            raise KeyError(f"{path}{k} is in the shared schema already")
        else:
            b[k] = v


with open(_DEFAULT_CFG_PATH, "rb") as _f:
    _default_cfg = tomllib.load(_f)
with open(_PORT_CFG_PATH, "rb") as _f:
    _add_keys(tomllib.load(_f), _default_cfg)
_default_cfg["LOG"] = {}

cfg = AttrDict(_default_cfg)

# Repo root: parent of the package directory, as in the JAX package.
cfg.ROOT_DIR = osp.abspath(osp.join(_PKG_DIR, ".."))
# Absolute DATA_DIR stays absolute under osp.join, matching the reference.
cfg.DATA_DIR = osp.join(cfg.ROOT_DIR, cfg.DATA_DIR)
cfg.DEBUG = os.environ.get("DEBUG") == "1"
# Rank of the current data-parallel worker, set by the training loop
# (reference set this in lib/train.py:106).
cfg.RANK = 0
cfg.GPU_ID = 0


def get_output_dir(imdb_name, net_name=None, output_dir="output", idx=-1):
    """Return (and create) output/<EXP_DIR>/<imdb>/<net_name>[/<idx>]."""
    outdir = osp.abspath(
        osp.join(cfg.ROOT_DIR, output_dir, cfg.EXP_DIR, imdb_name))
    if net_name is not None:
        outdir = osp.join(outdir, net_name)
    if idx >= 0:
        outdir = osp.join(outdir, str(idx))
    os.makedirs(outdir, exist_ok=True)
    return outdir


def _dumpable(tree):
    """Strip keys that are not TOML-serializable (runtime-injected paths)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _dumpable(v)
        elif isinstance(v, (bool, int, float, str, list, tuple)):
            out[k] = v
    return out


def cfg_print(tree):
    print("\x1b[32m\x1b[1m" + "#" * 20 + " Configuration Begins " + "#" * 20 +
          "\x1b[0m")
    print(tomlout.dumps(_dumpable(tree)))
    print("\x1b[32m\x1b[1m" + "#" * 20 + " Configuration Ends " + "#" * 20 +
          "\x1b[0m")


def cfg_dump(tree, fp):
    tomlout.dump(_dumpable(tree), fp)


def cfg_table(tree):
    """Markdown |key|value| table of the config (reference get_config.py:80-91)."""
    table = "|key|value|\n|---|---|\n"
    for raw_line in tomlout.dumps(_dumpable(tree)).split("\n"):
        parts = raw_line.split("=")
        if len(parts) == 1 and parts[0].strip():
            table += "|**{}**||\n".format(parts[0].strip())
        elif len(parts) >= 2:
            table += "|{}|{}|\n".format(parts[0].strip(),
                                        "=".join(parts[1:]).strip())
    return table


def _merge_a_into_b(a, b, path=""):
    """Merge dict a into AttrDict b: every key of a must already exist in b
    with a compatible type (get_config.py:94-131)."""
    for k, v in a.items():
        if k == "LOG":
            continue
        here = f"{path}{k}"
        if k not in b:
            raise KeyError(f"{here} is not a valid config key")
        old = b[k]
        if isinstance(v, dict):
            if not isinstance(old, dict):
                raise ValueError(f"Type mismatch for config key: {here}")
            _merge_a_into_b(v, old, path=here + ".")
            continue
        if old is not None and not isinstance(old, dict):
            ok = (
                type(old) is type(v)
                or (isinstance(old, float) and isinstance(v, int))
                or (isinstance(old, list) and isinstance(v, (list, tuple))))
            if not ok:
                raise ValueError("Type mismatch ({} vs. {}) for config key: {}"
                                 .format(type(old), type(v), here))
            if isinstance(old, float) and isinstance(v, int):
                v = float(v)
        b[k] = v


def cfg_from_file(filename):
    """Load a TOML config file and merge it into the defaults."""
    with open(filename, "rb") as f:
        amend = tomllib.load(f)
    _merge_a_into_b(amend, cfg)


def cfg_from_list(cfg_list):
    """Set config keys from a flat [key, value, key, value, ...] list."""
    assert len(cfg_list) % 2 == 0, "--amend expects key/value pairs"
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split(".")
        d = cfg
        for subkey in key_list[:-1]:
            assert subkey in d, f"Please put {subkey} in default.toml"
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, f"Please put {subkey} in default.toml"
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v  # plain string literal
        d[subkey] = value
