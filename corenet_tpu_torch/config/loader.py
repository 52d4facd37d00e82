"""Config loading: JSON5 files, jq-style structural transforms, -D template
overrides, and dotted-path --set overrides.

A near-copy of corenet_tpu/config/loader.py with its imports renamed:
`-jq <program>` applies a jq program to the raw config dict (delegated to
a `jq` binary when one is on PATH), `-D key=value` overrides string
templates, and `--set a.b.c=json_value` is the built-in structural
override that needs no external tool. `json5` is optional: without it the
files must be plain JSON.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from typing import Any, List, Mapping, Optional, Type

from corenet_tpu_torch.config import config as cfg
from corenet_tpu_torch.utils import fs

try:
  import json5  # type: ignore
  _loads = json5.loads
except ImportError:  # pragma: no cover
  _loads = json.loads


def apply_jq(data: Any, program: str) -> Any:
  """Applies a jq program via the system jq binary."""
  jq_bin = shutil.which("jq")
  if not jq_bin:
    raise RuntimeError(
        "A '-jq' transform was requested but no 'jq' binary is available. "
        "Use --set dotted-path overrides instead.")
  out = subprocess.run([jq_bin, program], input=json.dumps(data),
                       capture_output=True, text=True, check=True)
  return json.loads(out.stdout)


def apply_set_overrides(data: Any, overrides: List[str]) -> Any:
  """Applies 'a.b.0.c=json_value' structural overrides to a config dict."""
  for ov in overrides:
    path, _, value = ov.partition("=")
    try:
      value = json.loads(value)
    except json.JSONDecodeError:
      pass  # keep as string
    keys = path.split(".")
    node = data
    for k in keys[:-1]:
      node = node[int(k)] if isinstance(node, list) else node[k]
    last = keys[-1]
    if isinstance(node, list):
      node[int(last)] = value
    else:
      node[last] = value
  return data


def load_config_file(path: str,
                     config_cls: Type,
                     jq_transforms: Optional[List[str]] = None,
                     set_overrides: Optional[List[str]] = None,
                     template_overrides: Optional[Mapping[str, str]] = None):
  """Reads a JSON5 config and applies the full post-processing chain:
  jq transforms → --set overrides → dataclass parse → template substitution
  (with -D overrides seeding the template map)."""
  data = _loads(fs.read_text(path))
  return post_process_config(data, config_cls, jq_transforms, set_overrides,
                             template_overrides)


def post_process_config(data: Any,
                        config_cls: Type,
                        jq_transforms: Optional[List[str]] = None,
                        set_overrides: Optional[List[str]] = None,
                        template_overrides: Optional[Mapping[str, str]] = None):
  for program in (jq_transforms or []):
    data = apply_jq(data, program)
  data = apply_set_overrides(data, list(set_overrides or []))
  parsed = cfg.config_from_dict(config_cls, data)
  template_values = dict(template_overrides or {})
  return cfg.replace_templates(parsed, template_values)
