"""Model families: everything of the harness that depends on the model.

A configuration's family is the top-level `model_type` of its config.json
(`qwen2_5_vl` where the file has none). The family is the package
`qvbench/families/<model_type>/`, found by that name as a metric's reader
is, so that a configuration of another family comes in as new files
alone. The harness reaches a model only through the names in `REQUIRED`
and, where the family has them, those in `OPTIONAL`:

  load_spec(path)              the configuration's sizes: `.name`, `.path`
                               (its config.json), `.run` (the "qvbench"
                               block: dtype, param_dtype, ...), `.layers`
  LVU_MODEL_TYPE               the port's `LVUConfig.model_type`
  make_params(spec, seed, device, dtype)
                               seeded weights in the port's parameter tree
  group_frames(spec, mix), group_tokens(spec, mix),
  patches_per_group(spec, mix), prefix_len(spec), suffix_len(spec, question)
                               the mix's shapes in this model's tokens (the
                               `Mix` methods of qvbench/traffic.py ask them)
  kv_variant(spec, record)     the KV cache kind a served request used
  NUMBERS, check_program(tree, spec, mix, pool, records, device)
                               the numbers compared and the comparison with
                               the family's plain reference
  control_unavailable(spec)    None where `check_control(tree, spec, mix,
                               pool, records, device)` gives the control's
                               readings; else the reason why there is none
  request_ops(spec, mix, question, n_tokens)
                               operations by type of one request
  b1_group_bound_s, vision_mlp_bounds_s
                               optional kernel bounds; a reader whose bound
                               the family lacks returns None
"""

from __future__ import annotations

import functools
import importlib
import json
from pathlib import Path

DEFAULT = "qwen2_5_vl"

REQUIRED = ("load_spec", "LVU_MODEL_TYPE", "make_params", "group_frames",
            "group_tokens", "patches_per_group", "prefix_len", "suffix_len",
            "kv_variant", "NUMBERS", "check_program", "control_unavailable",
            "request_ops")
OPTIONAL = ("check_control", "b1_group_bound_s", "vision_mlp_bounds_s")


@functools.lru_cache(maxsize=None)
def model_type(config_file) -> str:
    """The family's name: the config's top-level `model_type`."""
    raw = json.loads(Path(config_file).read_text())
    return raw.get("model_type", DEFAULT)


@functools.lru_cache(maxsize=None)
def load(name: str):
    """The family package `name`; stops the run where there is none, or
    where it lacks a required name."""
    folder = Path(__file__).resolve().parent / name
    if not name.isidentifier() or not (folder / "__init__.py").is_file():
        raise SystemExit(f"model_type {name!r}: no family package "
                         f"qvbench/families/{name}/")
    family = importlib.import_module(f"{__name__}.{name}")
    names = set(dir(family))
    missing = [n for n in REQUIRED if n not in names]
    if missing:
        raise SystemExit(f"family qvbench/families/{name}/ lacks {missing}")
    return family


def of_config(config_file):
    return load(model_type(Path(config_file).resolve()))


def of_spec(spec):
    """The family of a spec that a family's `load_spec` gave."""
    return of_config(spec.path)
